"""The port's app/launcher.py driven headless through the fake-Tk double:
tests/test_launcher.py's cases on the port's launcher (form -> argv ->
config round trip, sexagesimal coordinates, presets through the UI, the
calendar popup, validation errors), a child that is spawned and runs the
port's CLI, and a launcher process that never imports torch."""

import os
from types import SimpleNamespace

import pytest

import tests.fake_tk as fake_tk


class FakeProcess:
    """multiprocessing.Process stand-in capturing the child argv."""

    spawned: list = []

    def __init__(self, target=None, args=()):
        self.target = target
        self.args = args
        FakeProcess.spawned.append(self)

    def start(self):
        pass

    def join(self):
        pass


class FakeThread:
    def __init__(self, target=None, daemon=None):
        self.target = target

    def start(self):
        self.target()


@pytest.fixture
def launcher(monkeypatch, tmp_path):
    import moonrtx_tpu_torch.app.launcher as launcher_mod

    fake_tk.install(monkeypatch)
    monkeypatch.chdir(tmp_path)  # presets land in tmp/presets
    FakeProcess.spawned = []
    contexts = []

    def get_context(method):
        contexts.append(method)
        return SimpleNamespace(Process=FakeProcess)

    monkeypatch.setattr(launcher_mod, "multiprocessing",
                        SimpleNamespace(get_context=get_context))
    monkeypatch.setattr(launcher_mod, "threading",
                        SimpleNamespace(Thread=FakeThread))
    # no download attempts during form validation
    import moonrtx_tpu_torch.app.cli as cli_mod

    monkeypatch.setattr(cli_mod, "_check_file",
                        lambda path, default, url, size, label, dl=True: None)
    monkeypatch.setattr(cli_mod, "check_color_file",
                        lambda path, allow_download=True: None)

    launcher_mod.run_launcher()
    root = fake_tk.roots[-1]

    def var_of(value):
        """The form StringVar currently holding `value`."""
        for v in fake_tk.variables:
            if isinstance(v, fake_tk.StringVar) and v.get() == value:
                return v
        raise AssertionError(f"no form variable holds {value!r}")

    def run():
        fake_tk.find_buttons(root, "Run")[0].invoke()
        assert FakeProcess.spawned, "renderer child was not spawned"
        return FakeProcess.spawned[-1].args[0]

    return SimpleNamespace(root=root, var_of=var_of, run=run,
                           mod=launcher_mod, contexts=contexts)


def _argv_value(argv, flag):
    return argv[argv.index(flag) + 1]


def test_form_to_argv_to_config_round_trip(launcher):
    from moonrtx_tpu_torch.app.cli import config_from_args, parse_args

    launcher.var_of("50.0614").set("48.25")  # lat
    launcher.var_of("19.9365").set("-17.5")  # lon
    launcher.var_of("0").set("219")          # elevation (m) — set FIRST so
    launcher.var_of("80").set("95")          # brightness
    launcher.var_of("10").set("12")          # shadow accuracy
    launcher.var_of("1920x1080").set("640x360")
    launcher.var_of("1").set("4")            # devices
    launcher.var_of("0").set("2.5")          # ...the remaining "0" is hbm
    argv = launcher.run()

    args = parse_args(argv + ["--no-download"])
    cfg = config_from_args(args)
    assert cfg.observer.lat == pytest.approx(48.25)
    assert cfg.observer.lon == pytest.approx(-17.5)
    assert cfg.observer.elevation_m == 219
    assert cfg.brightness == 95
    assert cfg.shadow_accuracy == 12
    assert (cfg.width, cfg.height) == (640, 360)
    assert cfg.devices == 4
    assert cfg.hbm_budget_gb == pytest.approx(2.5)
    cfg.validate()


def test_sexagesimal_entry(launcher):
    # switch to D/M/S and run: lat = 50 deg 3 min 41 s N
    dms = [w for w in fake_tk.descendants(launcher.root)
           if isinstance(w, fake_tk.Radiobutton)
           and w.kw.get("text") == "D/M/S"][0]
    dms.invoke()
    argv = launcher.run()
    from moonrtx_tpu_torch.app.presets import sexagesimal_to_decimal

    expected = sexagesimal_to_decimal(50, 3, 41, "N")
    assert float(_argv_value(argv, "--lat")) == pytest.approx(expected)
    assert expected == pytest.approx(50.0614, abs=1e-3)
    # S/W hemispheres negate
    assert sexagesimal_to_decimal(19, 56, 11, "W") < 0


def test_preset_save_load_roundtrip_carries_every_field(launcher):
    from moonrtx_tpu_torch.app import presets as presets_mod

    # name the preset via the combobox variable, tweak fields, save
    boxes = [w for w in fake_tk.descendants(launcher.root)
             if isinstance(w, fake_tk.ttk.Combobox)
             and w.kw.get("width") == 16]
    assert boxes, "preset combobox missing"
    boxes[0].set("roundtrip")
    launcher.var_of("80").set("93")          # brightness
    launcher.var_of("1").set("8")            # devices
    fake_tk.find_buttons(launcher.root, "Save")[0].invoke()

    data = presets_mod.load_preset("roundtrip")
    assert data is not None
    # every launcher field is carried (round-3 fix: PRESET_KEYS dropped
    # photometric/eclipse/earthshine/devices/hbm)
    for key in ("lat", "lon", "elevation", "time", "utc_offset",
                "downscale", "brightness", "gamma", "time_step_minutes",
                "view_orientation", "parallactic_mode", "shadow_accuracy",
                "backend", "photometric", "eclipse_shading", "earthshine",
                "width", "height", "devices", "hbm_budget_gb",
                "elevation_file", "color_file", "starmap_file",
                "features_file", "init_view"):
        assert key in data, key
    assert data["brightness"] == 93
    assert data["devices"] == 8

    # change the form, Load restores it
    launcher.var_of("93").set("77")
    fake_tk.find_buttons(launcher.root, "Load")[0].invoke()
    assert launcher.var_of("93") is not None  # restored by apply_values

    argv = launcher.run()
    assert _argv_value(argv, "--brightness") == "93"
    assert _argv_value(argv, "--devices") == "8"


def test_preset_missing_shows_error(launcher):
    boxes = [w for w in fake_tk.descendants(launcher.root)
             if isinstance(w, fake_tk.ttk.Combobox)
             and w.kw.get("width") == 16]
    boxes[0].set("no-such-preset")
    n0 = len(fake_tk.messagebox.messages)
    fake_tk.find_buttons(launcher.root, "Load")[0].invoke()
    assert len(fake_tk.messagebox.messages) == n0 + 1
    assert fake_tk.messagebox.messages[-1][0] == "error"


def test_calendar_popup_sets_date(launcher):
    cal_btn = fake_tk.find_buttons(launcher.root, "📅")[0]
    cal_btn.invoke()
    dlg = fake_tk.toplevels[-1]
    assert dlg.title() == "Calendar"
    # shift forward one month, then pick day 15
    fake_tk.find_buttons(dlg, ">")[0].invoke()
    fake_tk.find_buttons(dlg, "15")[0].invoke()
    # the date entry now holds ...-15 in the shifted month
    from datetime import datetime

    date_vals = [v.get() for v in fake_tk.variables
                 if isinstance(v, fake_tk.StringVar)
                 and str(v.get()).endswith("-15")]
    assert date_vals, "calendar pick did not set the date variable"
    picked = datetime.strptime(date_vals[0], "%Y-%m-%d")
    assert picked.day == 15
    assert dlg.destroyed


def test_invalid_form_value_shows_error_no_spawn(launcher):
    launcher.var_of("80").set("not-a-number")
    n0 = len(fake_tk.messagebox.messages)
    fake_tk.find_buttons(launcher.root, "Run")[0].invoke()
    assert not FakeProcess.spawned
    assert len(fake_tk.messagebox.messages) == n0 + 1
    kind, _, msg = fake_tk.messagebox.messages[-1]
    assert kind == "error" and "Invalid form value" in msg


def test_invalid_init_view_shows_error(launcher):
    # the init-view entry starts empty; find it among empty StringVars by
    # setting through the labeled row's entry widget
    rows = [w for w in fake_tk.descendants(launcher.root)
            if isinstance(w, fake_tk.Label)
            and w.kw.get("text") == "Init view:"]
    assert rows
    entries = [w for w in fake_tk.descendants(launcher.root)
               if isinstance(w, fake_tk.Entry) and w.kw.get("width") == 44]
    entries[0].kw["textvariable"].set("garbage-not-a-view")
    n0 = len(fake_tk.messagebox.messages)
    fake_tk.find_buttons(launcher.root, "Run")[0].invoke()
    assert not FakeProcess.spawned
    assert len(fake_tk.messagebox.messages) == n0 + 1
    assert "init view" in fake_tk.messagebox.messages[-1][2].lower()


def test_run_reenables_button_after_child_exit(launcher):
    argv = launcher.run()
    assert "--lat" in argv
    # the child is spawned, never forked, and runs the port's CLI
    assert launcher.contexts == ["spawn"]
    assert FakeProcess.spawned[-1].target is launcher.mod._renderer_child
    # FakeThread ran the monitor synchronously: the after(0, ...) re-enable
    # is pending on the root timer queue
    launcher.root.run_pending_after()
    btn = fake_tk.find_buttons(launcher.root, "Run")[0]
    assert btn.kw.get("state") == fake_tk.NORMAL


def test_launcher_process_never_imports_torch():
    """The launcher and the CLI module it checks files with load no torch
    (so no CUDA state a child could inherit): torch is imported by the
    child's check_accelerator, not before."""
    import subprocess
    import sys

    code = ("import sys; import moonrtx_tpu_torch.app.launcher, "
            "moonrtx_tpu_torch.app.cli; print('torch' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"
