"""The port's app layer against the reference: tests/test_app.py's cases
run on the port's modules (CLI parsing and validation, presets,
sexagesimal coordinates, status formatting, profiling, logging), the
CLI's flags, defaults and RenderConfig held to the reference's argv for
argv, and the port's own device rules: MOONRTX_PLATFORM picks the device,
and without a card the CLI exits instead of rendering on the CPU."""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch.app import cli, presets, status
from moonrtx_tpu_torch.app.cli import config_from_args, parse_args
from moonrtx_tpu_torch.types import MoonEphemeris
from moonrtx_tpu_torch.utils.profiling import FrameStats


def _args(*extra):
    return parse_args(["--lat", "50.0614", "--lon", "19.9365",
                       "--time", "2024-04-15T21:00:00Z", "--no-download",
                       *extra])


def test_cli_defaults_match_reference():
    a = _args()
    assert a.downscale == 3
    assert a.brightness == 80
    assert a.gamma == 2.2
    assert a.time_step_minutes == 15
    assert a.shadow_accuracy == 1
    assert a.init_view_orientation == "NSWE"


def test_cli_config_round_trip():
    cfg = config_from_args(_args("--shadow-accuracy", "10",
                                 "--parallactic-mode"))
    assert cfg.observer.lat == pytest.approx(50.0614)
    assert cfg.shadow_accuracy == 10
    assert cfg.parallactic_mode is True
    assert cfg.dt_local.tzinfo is not None


def _init_view_name():
    from datetime import datetime, timezone

    from moonrtx_tpu_torch.app.codec import format_view_state
    from moonrtx_tpu_torch.engine.scene import default_camera

    return format_view_state(datetime(2024, 1, 1, tzinfo=timezone.utc),
                             -34.6131, -58.3772, "SNEW", True,
                             default_camera())


def test_cli_init_view_restores_state():
    cfg = config_from_args(parse_args(["--init-view", _init_view_name(),
                                       "--no-download"]))
    assert cfg.observer.lat == pytest.approx(-34.6131)
    assert cfg.view_orientation == "SNEW"
    assert cfg.parallactic_mode is True
    assert cfg.initial_camera is not None


def test_cli_rejects_bad_values():
    with pytest.raises(SystemExit):
        config_from_args(parse_args(["--lat", "95", "--lon", "0",
                                     "--time", "2024-01-01T00:00:00Z",
                                     "--no-download"]))
    with pytest.raises(SystemExit):
        config_from_args(parse_args(["--lon", "0", "--no-download"]))


# ---- presets / coordinates ----

def test_sexagesimal_round_trip():
    for value, is_lat in ((50.0614, True), (-33.8688, True),
                          (151.2093, False), (-58.3772, False)):
        d, m, s, h = presets.decimal_to_sexagesimal(value, is_lat)
        back = presets.sexagesimal_to_decimal(d, m, s, h)
        assert back == pytest.approx(value, abs=1e-5)


def test_utc_offsets_range():
    offs = presets.utc_offsets()
    assert offs[0] == "-12:00"
    assert offs[-1] == "+14:00"
    assert "+05:30" in offs  # 30-minute steps


def test_preset_save_load(tmp_path):
    values = {"lat": 1.5, "lon": 2.5, "brightness": 90, "junk": "dropped"}
    presets.save_preset("demo", values, str(tmp_path))
    assert presets.list_presets(str(tmp_path)) == ["demo"]
    loaded = presets.load_preset("demo", str(tmp_path))
    assert loaded == {"lat": 1.5, "lon": 2.5, "brightness": 90}
    assert presets.load_preset("missing", str(tmp_path)) is None


def test_preset_carries_data_files_and_init_view(tmp_path):
    values = {"elevation_file": "/d/ldem.tif", "color_file": "/d/color.tif",
              "starmap_file": "/d/stars.tif", "features_file": "/d/f.csv",
              "init_view": "2024-04-15_2100_50.06_19.94_viewNSWE_par0_camX"}
    presets.save_preset("files", values, str(tmp_path))
    assert presets.load_preset("files", str(tmp_path)) == values


# ---- status formatting ----

def test_dms_hms_formatting():
    assert status.fmt_dms(12.5084, signed=False).startswith("12°30'")
    assert status.fmt_dms(-0.5).startswith("-0°30'")
    assert status.fmt_hms(187.7).startswith("12h30m")


def test_illumination_percent():
    assert status.illumination_percent(0.0) == pytest.approx(100.0)
    assert status.illumination_percent(90.0) == pytest.approx(50.0)
    assert status.illumination_percent(180.0) == pytest.approx(0.0, abs=1e-9)


def test_info_panel_rows():
    e = MoonEphemeris(az=120.0, alt=45.0, ra=187.7, dec=-5.0, distance=384400,
                      sun_distance=1.496e8, phase_angle=90.0,
                      bright_limb_angle=67.0, libr_long_geo=1.0,
                      libr_lat_geo=2.0, libr_long_topo=1.1, libr_lat_topo=2.1,
                      elongation=90.0, phase_name="First Quarter",
                      colongitude=0.5, rotation_matrix=np.eye(3))
    rows = status.info_panel_rows(e)
    assert len(rows) == 14
    d = dict(rows)
    assert d["Phase"] == "First Quarter"
    assert d["Illumination"] == "50.0%"


# ---- profiling ----

def test_frame_stats():
    import time

    fs = FrameStats(window=10)
    fs.tick()
    for _ in range(3):
        time.sleep(0.01)
        fs.tick()
    assert 30 < fs.fps < 200
    assert "FPS" in fs.status_text(1000)
    fs.reset()
    assert fs.fps == 0.0


def test_preset_carries_every_launcher_field(tmp_path):
    values = {"photometric": "lunar", "eclipse_shading": False,
              "earthshine": False, "devices": 8, "hbm_budget_gb": 12.5}
    presets.save_preset("phys", values, str(tmp_path))
    assert presets.load_preset("phys", str(tmp_path)) == values


def test_synth_shape_flag_round_trip():
    cfg = config_from_args(parse_args(
        ["--lat", "50", "--lon", "19", "--no-download",
         "--synth-shape", "23040x46080"]))
    assert cfg.synth_shape == (23040, 46080)
    cfg = config_from_args(parse_args(
        ["--lat", "50", "--lon", "19", "--no-download"]))
    assert cfg.synth_shape is None


def test_synth_shape_flag_malformed_exits():
    with pytest.raises(SystemExit):
        config_from_args(parse_args(
            ["--lat", "50", "--lon", "19", "--no-download",
             "--synth-shape", "banana"]))


# ---- the CLI against the reference's, argv for argv ----

BASE = ["--lat", "50.0614", "--lon", "19.9365",
        "--time", "2024-04-15T21:00:00Z", "--no-download"]
DATA_FILES = ("elevation_file", "color_file", "starmap_file")


def _plain(v):
    """A value of either package's types as plain Python, for equality."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return {k: _plain(getattr(v, k)) for k in v._fields}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


@pytest.mark.parametrize("argv", [
    BASE,
    BASE + ["--shadow-accuracy", "10", "--parallactic-mode", "--backend",
            "pallas", "--accumulation-frames", "32"],
    ["--init-view", "INIT_VIEW", "--no-download"],
    BASE + ["--devices", "0", "--hbm-budget-gb", "2.5",
            "--indirect-bounces", "2", "--no-indirect-light"],
    BASE + ["--synth-shape", "23040x46080", "--downscale", "1", "--width",
            "640", "--height", "360", "--photometric", "lunar",
            "--no-eclipse-shading", "--no-earthshine"],
    BASE + ["--headless", "--timelapse-frames", "4", "--save", "x.png",
            "--time-step-minutes", "720", "--brightness", "95", "--gamma",
            "1.8", "--init-view-orientation", "SNEW", "--elevation", "219",
            "--features-file", "f.csv", "--elevation-file", "/none/e.tif"],
], ids=["base", "pallas", "init-view", "devices-0", "synth", "headless"])
def test_cli_matches_reference(argv):
    """Every dest and default of the reference's parse_args, and an equal
    RenderConfig, field by field. The default data files live in each
    package's own data directory: the same file names."""
    from moonrtx_tpu.app import cli as jcli

    argv = [_init_view_name() if a == "INIT_VIEW" else a for a in argv]
    got, want = vars(parse_args(argv)), vars(jcli.parse_args(argv))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in DATA_FILES and "--" + k.replace("_", "-") not in argv:
            assert os.path.basename(got[k]) == os.path.basename(v), k
        else:
            assert got[k] == v, k
    c_t = config_from_args(parse_args(argv))
    c_j = jcli.config_from_args(jcli.parse_args(argv))
    assert [f.name for f in dataclasses.fields(c_t)] == [
        f.name for f in dataclasses.fields(c_j)]
    for f in dataclasses.fields(c_j):
        assert _plain(getattr(c_t, f.name)) == _plain(
            getattr(c_j, f.name)), f.name


def test_cli_description_names_the_port(capsys):
    from moonrtx_tpu_torch import APP_NAME

    with pytest.raises(SystemExit):
        parse_args(["--help"])
    assert APP_NAME in capsys.readouterr().out


# ---- the device: MOONRTX_PLATFORM, and no silent CPU ----

@pytest.fixture
def entry_points(monkeypatch):
    """main's three renderers replaced by recorders of their arguments."""
    from moonrtx_tpu_torch.app import headless, window

    calls = []
    for mod, name in ((headless, "render_headless"),
                      (headless, "render_timelapse"),
                      (window, "run_window")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(
            (_n, a, k)))
    return calls


def test_main_without_a_card_exits_instead_of_using_the_cpu(
        monkeypatch, capsys, entry_points):
    monkeypatch.delenv("MOONRTX_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + ["--headless", "--save", "x.png"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "no CUDA device" in out and "MOONRTX_PLATFORM=cpu" in out
    assert "Saved:" not in out and entry_points == []


def test_main_rejects_an_unknown_platform(monkeypatch, capsys,
                                          entry_points):
    monkeypatch.setenv("MOONRTX_PLATFORM", "tpu")
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + ["--headless"])
    assert e.value.code == 1 and entry_points == []
    assert "MOONRTX_PLATFORM" in capsys.readouterr().out


@pytest.mark.parametrize("extra,entry", [
    (["--headless", "--accumulation-frames", "3"], "render_headless"),
    (["--headless", "--timelapse-frames", "4"], "render_timelapse"),
    ([], "run_window")])
def test_main_runs_on_the_platform_asked_for(monkeypatch, capsys,
                                             entry_points, extra, entry):
    monkeypatch.setenv("MOONRTX_PLATFORM", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli.main(BASE + ["--devices", "0"] + extra)
    assert "Accelerator: cpu" in capsys.readouterr().out
    (name, args, kw), = entry_points
    assert name == entry and kw["device"] == "cpu"
    assert args[0].devices == 0
    if entry == "render_headless":
        assert kw["n_frames"] == 3
    if entry == "render_timelapse":
        assert args[2] == 4


def test_main_reports_the_card(monkeypatch, capsys, entry_points):
    monkeypatch.delenv("MOONRTX_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cli.main(BASE + ["--headless"])
    assert ("Accelerator: cuda (NVIDIA H100 80GB HBM3 x1)"
            in capsys.readouterr().out)
    (name, _, kw), = entry_points
    assert name == "render_headless" and kw["device"] is None


@pytest.mark.parametrize("cards,devices,ok", [
    (1, "4", False), (4, "4", True), (2, "0", True), (1, "1", True)])
def test_main_builds_the_mesh_asked_for(monkeypatch, capsys, entry_points,
                                        cards, devices, ok):
    """--devices N needs N cards: on a host with fewer it exits 1 with
    make_mesh's message and renders nothing; 0 is every card."""
    monkeypatch.delenv("MOONRTX_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if not ok:
        with pytest.raises(SystemExit) as e:
            cli.main(BASE + ["--devices", devices, "--headless"])
        assert e.value.code == 1 and entry_points == []
        out = capsys.readouterr().out
        assert f"make_mesh({devices})" in out and f"only {cards}" in out
        return
    cli.main(BASE + ["--devices", devices, "--headless"])
    out = capsys.readouterr().out
    n = cards if devices == "0" else int(devices)
    assert (f"Devices: {n} " in out) == (n > 1)
    (name, args, _), = entry_points
    assert name == "render_headless" and args[0].devices == int(devices)


def test_log_event_is_one_json_line(monkeypatch):
    from moonrtx_tpu_torch.utils import log

    monkeypatch.setattr(log, "_LOGGER", None)
    logger = log.get_logger()
    assert logger.name == "moonrtx_tpu_torch" and not logger.propagate
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    keep = Keep()
    logger.addHandler(keep)
    try:
        log.log_event("upload", bands=5)
    finally:
        logger.removeHandler(keep)
    rec = json.loads(records[-1])
    assert rec["event"] == "upload" and rec["bands"] == 5 and rec["t"] > 0
