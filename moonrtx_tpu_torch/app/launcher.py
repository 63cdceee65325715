"""Tk GUI launcher: a form over every CLI parameter, JSON presets, and a
renderer child process (torch port of moonrtx_tpu/app/launcher.py).

Fills the role of the reference launcher (main_gui_launcher.py): decimal
and sexagesimal coordinate entry with N/S-E/W selectors, a calendar popup,
a UTC-offset combobox (-12:00..+14:00 in 30-minute steps), named JSON
presets, and launching the renderer in a separate process with a monitor
thread that re-enables the Run button when it exits.

The launcher process never touches the CUDA card: the form checks files
only, and torch is first imported by the child (app.cli.check_accelerator).
The child is spawned, not forked, because a forked child of a process
whose CUDA state exists cannot use the card.
"""

from __future__ import annotations

import calendar
import multiprocessing
import threading
from datetime import datetime

from moonrtx_tpu_torch import APP_NAME
from moonrtx_tpu_torch.app import presets as presets_mod
from moonrtx_tpu_torch.orientation import VIEW_ORIENTATIONS


def _renderer_child(argv: list) -> None:
    from moonrtx_tpu_torch.app.cli import main
    main(argv)


def run_launcher() -> None:
    import tkinter as tk
    from tkinter import ttk, messagebox

    root = tk.Tk()
    root.title(f"{APP_NAME} Launcher")

    form = tk.Frame(root, padx=12, pady=10)
    form.pack(fill=tk.BOTH, expand=True)
    row = [0]

    def add_row(label):
        tk.Label(form, text=label, anchor="e", width=18).grid(
            row=row[0], column=0, sticky="e", pady=2)
        frame = tk.Frame(form)
        frame.grid(row=row[0], column=1, sticky="w", pady=2)
        row[0] += 1
        return frame

    # --- coordinates: decimal or sexagesimal ------------------------------
    coord_mode = tk.StringVar(value="decimal")
    fr = add_row("Coordinates:")
    tk.Radiobutton(fr, text="Decimal", variable=coord_mode,
                   value="decimal").pack(side=tk.LEFT)
    tk.Radiobutton(fr, text="D/M/S", variable=coord_mode,
                   value="dms").pack(side=tk.LEFT)

    lat_var = tk.StringVar(value="50.0614")
    lon_var = tk.StringVar(value="19.9365")
    fr = add_row("Latitude:")
    tk.Entry(fr, textvariable=lat_var, width=12).pack(side=tk.LEFT)
    lat_d, lat_m, lat_s = (tk.StringVar(value="50"), tk.StringVar(value="3"),
                           tk.StringVar(value="41"))
    lat_h = tk.StringVar(value="N")
    for var, wdt in ((lat_d, 4), (lat_m, 3), (lat_s, 5)):
        tk.Entry(fr, textvariable=var, width=wdt).pack(side=tk.LEFT, padx=1)
    ttk.Combobox(fr, textvariable=lat_h, values=["N", "S"],
                 width=2, state="readonly").pack(side=tk.LEFT, padx=2)

    fr = add_row("Longitude:")
    tk.Entry(fr, textvariable=lon_var, width=12).pack(side=tk.LEFT)
    lon_d, lon_m, lon_s = (tk.StringVar(value="19"), tk.StringVar(value="56"),
                           tk.StringVar(value="11"))
    lon_h = tk.StringVar(value="E")
    for var, wdt in ((lon_d, 4), (lon_m, 3), (lon_s, 5)):
        tk.Entry(fr, textvariable=var, width=wdt).pack(side=tk.LEFT, padx=1)
    ttk.Combobox(fr, textvariable=lon_h, values=["E", "W"],
                 width=2, state="readonly").pack(side=tk.LEFT, padx=2)

    elev_var = tk.StringVar(value="0")
    tk.Entry(add_row("Elevation (m):"), textvariable=elev_var,
             width=8).pack(side=tk.LEFT)

    # --- date/time + calendar popup ---------------------------------------
    now = datetime.now().astimezone()
    date_var = tk.StringVar(value=now.strftime("%Y-%m-%d"))
    time_var = tk.StringVar(value=now.strftime("%H:%M:%S"))
    offset = now.strftime("%z")
    utc_var = tk.StringVar(value=f"{offset[:3]}:{offset[3:]}" if offset
                           else "+00:00")
    fr = add_row("Date:")
    tk.Entry(fr, textvariable=date_var, width=12).pack(side=tk.LEFT)

    def open_calendar():
        try:
            base = datetime.strptime(date_var.get(), "%Y-%m-%d")
        except ValueError:
            base = now
        win = tk.Toplevel(root)
        win.title("Calendar")
        state = {"y": base.year, "m": base.month}
        header = tk.Label(win)
        header.grid(row=0, column=1, columnspan=5)
        grid = tk.Frame(win)
        grid.grid(row=1, column=0, columnspan=7)

        def redraw():
            for child in grid.winfo_children():
                child.destroy()
            header.config(text=f"{calendar.month_name[state['m']]} {state['y']}")
            for i, d in enumerate(["Mo", "Tu", "We", "Th", "Fr", "Sa", "Su"]):
                tk.Label(grid, text=d, width=3).grid(row=0, column=i)
            for r, week in enumerate(calendar.monthcalendar(state["y"],
                                                            state["m"])):
                for c, day in enumerate(week):
                    if day == 0:
                        continue
                    def pick(d=day):
                        date_var.set(f"{state['y']:04d}-{state['m']:02d}-{d:02d}")
                        win.destroy()
                    tk.Button(grid, text=str(day), width=3,
                              command=pick).grid(row=r + 1, column=c)

        def shift(dm):
            state["m"] += dm
            if state["m"] < 1:
                state["m"], state["y"] = 12, state["y"] - 1
            elif state["m"] > 12:
                state["m"], state["y"] = 1, state["y"] + 1
            redraw()

        tk.Button(win, text="<", command=lambda: shift(-1)).grid(row=0, column=0)
        tk.Button(win, text=">", command=lambda: shift(+1)).grid(row=0, column=6)
        redraw()

    tk.Button(fr, text="📅", command=open_calendar).pack(side=tk.LEFT, padx=2)
    fr = add_row("Time:")
    tk.Entry(fr, textvariable=time_var, width=10).pack(side=tk.LEFT)
    ttk.Combobox(fr, textvariable=utc_var, values=presets_mod.utc_offsets(),
                 width=7, state="readonly").pack(side=tk.LEFT, padx=4)

    # --- data files (pickers, reference main_gui_launcher.py:137-347) ------
    from moonrtx_tpu_torch.app import cli as cli_mod
    from tkinter import filedialog

    def add_file_row(label, default):
        var = tk.StringVar(value=default)
        fr2 = add_row(label)
        tk.Entry(fr2, textvariable=var, width=38).pack(side=tk.LEFT)

        def browse():
            path = filedialog.askopenfilename(title=label)
            if path:
                var.set(path)
        tk.Button(fr2, text="...", command=browse).pack(side=tk.LEFT, padx=2)
        return var

    elevfile_var = add_file_row("Elevation file:", cli_mod.ELEVATION_FILE_LOCAL)
    colorfile_var = add_file_row("Color file:", cli_mod.COLOR_FILE_LOCAL)
    starfile_var = add_file_row("Star map file:", cli_mod.STARMAP_FILE_LOCAL)
    featfile_var = add_file_row("Features file:", "")

    # --- init-view (restores a screenshot's full view state) ---------------
    initview_var = tk.StringVar(value="")
    tk.Entry(add_row("Init view:"), textvariable=initview_var,
             width=44).pack(side=tk.LEFT)

    # --- render parameters -------------------------------------------------
    downscale_var = tk.StringVar(value="3")
    brightness_var = tk.StringVar(value="80")
    gamma_var = tk.StringVar(value="2.2")
    step_var = tk.StringVar(value="15")
    orient_var = tk.StringVar(value=VIEW_ORIENTATIONS[0])
    parallactic_var = tk.BooleanVar(value=False)
    shadow_var = tk.StringVar(value="10")
    backend_var = tk.StringVar(value="auto")
    photometric_var = tk.StringVar(value="lambert")
    eclipse_var = tk.BooleanVar(value=True)
    earthshine_var = tk.BooleanVar(value=True)
    size_var = tk.StringVar(value="1920x1080")
    devices_var = tk.StringVar(value="1")
    hbm_var = tk.StringVar(value="0")

    tk.Entry(add_row("Downscale:"), textvariable=downscale_var,
             width=4).pack(side=tk.LEFT)
    tk.Entry(add_row("Brightness:"), textvariable=brightness_var,
             width=5).pack(side=tk.LEFT)
    tk.Entry(add_row("Gamma:"), textvariable=gamma_var,
             width=5).pack(side=tk.LEFT)
    tk.Entry(add_row("Time step (min):"), textvariable=step_var,
             width=5).pack(side=tk.LEFT)
    ttk.Combobox(add_row("View orientation:"), textvariable=orient_var,
                 values=VIEW_ORIENTATIONS, width=6,
                 state="readonly").pack(side=tk.LEFT)
    tk.Checkbutton(add_row("Parallactic mode:"),
                   variable=parallactic_var).pack(side=tk.LEFT)
    tk.Entry(add_row("Shadow accuracy:"), textvariable=shadow_var,
             width=4).pack(side=tk.LEFT)
    ttk.Combobox(add_row("Backend:"), textvariable=backend_var,
                 values=["auto", "pallas", "blocked", "reference"],
                 width=10, state="readonly").pack(side=tk.LEFT)
    ttk.Combobox(add_row("Photometric:"), textvariable=photometric_var,
                 values=["lambert", "lunar"],
                 width=10, state="readonly").pack(side=tk.LEFT)
    tk.Checkbutton(add_row("Eclipse shading:"),
                   variable=eclipse_var).pack(side=tk.LEFT)
    tk.Checkbutton(add_row("Earthshine:"),
                   variable=earthshine_var).pack(side=tk.LEFT)
    tk.Entry(add_row("Size:"), textvariable=size_var,
             width=10).pack(side=tk.LEFT)
    fr_dev = add_row("Devices:")
    tk.Entry(fr_dev, textvariable=devices_var, width=4).pack(side=tk.LEFT)
    tk.Label(fr_dev, text="(0 = all)").pack(side=tk.LEFT, padx=2)
    fr_hbm = add_row("HBM budget (GiB):")
    tk.Entry(fr_hbm, textvariable=hbm_var, width=6).pack(side=tk.LEFT)
    tk.Label(fr_hbm, text="(0 = auto)").pack(side=tk.LEFT, padx=2)

    # --- presets -------------------------------------------------------------
    preset_var = tk.StringVar()
    fr = add_row("Preset:")
    preset_box = ttk.Combobox(fr, textvariable=preset_var,
                              values=presets_mod.list_presets(), width=16)
    preset_box.pack(side=tk.LEFT)

    def form_values() -> dict:
        if coord_mode.get() == "dms":
            lat = presets_mod.sexagesimal_to_decimal(
                float(lat_d.get()), float(lat_m.get()), float(lat_s.get()),
                lat_h.get())
            lon = presets_mod.sexagesimal_to_decimal(
                float(lon_d.get()), float(lon_m.get()), float(lon_s.get()),
                lon_h.get())
        else:
            lat, lon = float(lat_var.get()), float(lon_var.get())
        w, h = size_var.get().lower().split("x")
        return {
            "lat": lat, "lon": lon, "elevation": int(elev_var.get()),
            "time": f"{date_var.get()}T{time_var.get()}{utc_var.get()}",
            "utc_offset": utc_var.get(),
            "downscale": int(downscale_var.get()),
            "brightness": int(brightness_var.get()),
            "gamma": float(gamma_var.get()),
            "time_step_minutes": int(step_var.get()),
            "view_orientation": orient_var.get(),
            "parallactic_mode": bool(parallactic_var.get()),
            "shadow_accuracy": int(shadow_var.get()),
            "backend": backend_var.get(),
            "photometric": photometric_var.get(),
            "eclipse_shading": bool(eclipse_var.get()),
            "earthshine": bool(earthshine_var.get()),
            "width": int(w), "height": int(h),
            "devices": int(devices_var.get()),
            "hbm_budget_gb": float(hbm_var.get()),
            "elevation_file": elevfile_var.get().strip(),
            "color_file": colorfile_var.get().strip(),
            "starmap_file": starfile_var.get().strip(),
            "features_file": featfile_var.get().strip(),
            "init_view": initview_var.get().strip(),
        }

    def apply_values(v: dict) -> None:
        if "lat" in v:
            lat_var.set(str(v["lat"]))
        if "lon" in v:
            lon_var.set(str(v["lon"]))
        if "elevation" in v:
            elev_var.set(str(v["elevation"]))
        if "time" in v and "T" in str(v["time"]):
            dt_part, t_part = str(v["time"]).split("T", 1)
            date_var.set(dt_part)
            time_var.set(t_part[:8])
        if "utc_offset" in v:
            utc_var.set(v["utc_offset"])
        for key, var in (("downscale", downscale_var),
                         ("brightness", brightness_var), ("gamma", gamma_var),
                         ("time_step_minutes", step_var),
                         ("shadow_accuracy", shadow_var)):
            if key in v:
                var.set(str(v[key]))
        if "view_orientation" in v:
            orient_var.set(v["view_orientation"])
        if "parallactic_mode" in v:
            parallactic_var.set(bool(v["parallactic_mode"]))
        if "backend" in v:
            backend_var.set(v["backend"])
        if "photometric" in v:
            photometric_var.set(v["photometric"])
        if "eclipse_shading" in v:
            eclipse_var.set(bool(v["eclipse_shading"]))
        if "earthshine" in v:
            earthshine_var.set(bool(v["earthshine"]))
        if "width" in v and "height" in v:
            size_var.set(f"{v['width']}x{v['height']}")
        if "devices" in v:
            devices_var.set(str(v["devices"]))
        if "hbm_budget_gb" in v:
            hbm_var.set(str(v["hbm_budget_gb"]))
        for key, var in (("elevation_file", elevfile_var),
                         ("color_file", colorfile_var),
                         ("starmap_file", starfile_var),
                         ("features_file", featfile_var),
                         ("init_view", initview_var)):
            if key in v:
                var.set(str(v[key]))

    def save_preset():
        name = preset_var.get().strip()
        if not name:
            messagebox.showerror(APP_NAME, "Enter a preset name first.")
            return
        try:
            presets_mod.save_preset(name, form_values())
        except Exception as e:
            messagebox.showerror(APP_NAME, f"Could not save preset: {e}")
            return
        preset_box["values"] = presets_mod.list_presets()

    def load_preset():
        name = preset_var.get().strip()
        data = presets_mod.load_preset(name)
        if data is None:
            messagebox.showerror(APP_NAME, f"Preset '{name}' not found.")
            return
        apply_values(data)

    tk.Button(fr, text="Save", command=save_preset).pack(side=tk.LEFT, padx=2)
    tk.Button(fr, text="Load", command=load_preset).pack(side=tk.LEFT)

    # --- run ----------------------------------------------------------------
    status_var = tk.StringVar()
    tk.Label(root, textvariable=status_var).pack()
    run_btn = tk.Button(root, text="Run", width=16)
    run_btn.pack(pady=8)

    def on_run():
        try:
            v = form_values()
        except Exception as e:
            messagebox.showerror(APP_NAME, f"Invalid form value: {e}")
            return
        # pre-spawn validation (reference main_gui_launcher.py:744-772):
        # init-view must parse; data files are checked (and the defaults
        # downloaded) BEFORE the child starts, so failures surface here
        if v["init_view"]:
            from moonrtx_tpu_torch.app import codec
            if codec.parse_init_view(v["init_view"]) is None:
                messagebox.showerror(
                    APP_NAME, f"Could not parse init view: {v['init_view']}")
                return
        status_var.set("Checking data files...")
        root.update_idletasks()
        cli_mod._check_file(
            v["elevation_file"] or cli_mod.ELEVATION_FILE_LOCAL,
            cli_mod.ELEVATION_FILE_LOCAL, cli_mod.ELEVATION_FILE_URL,
            cli_mod.ELEVATION_FILE_SIZE_BYTES, "elevation", True)
        cli_mod.check_color_file(v["color_file"] or cli_mod.COLOR_FILE_LOCAL)
        cli_mod._check_file(
            v["starmap_file"] or cli_mod.STARMAP_FILE_LOCAL,
            cli_mod.STARMAP_FILE_LOCAL, cli_mod.STARMAP_FILE_URL,
            cli_mod.STARMAP_FILE_SIZE_BYTES, "star map", True)

        argv = ["--elevation", str(v["elevation"]),
                "--downscale", str(v["downscale"]),
                "--brightness", str(v["brightness"]),
                "--gamma", str(v["gamma"]),
                "--time-step-minutes", str(v["time_step_minutes"]),
                "--shadow-accuracy", str(v["shadow_accuracy"]),
                "--backend", v["backend"],
                "--photometric", v.get("photometric", "lambert"),
                "--width", str(v["width"]), "--height", str(v["height"]),
                "--devices", str(v.get("devices", 1)),
                "--hbm-budget-gb", str(v.get("hbm_budget_gb", 0.0))]
        if not v.get("eclipse_shading", True):
            argv += ["--no-eclipse-shading"]
        if not v.get("earthshine", True):
            argv += ["--no-earthshine"]
        if v["init_view"]:
            argv += ["--init-view", v["init_view"]]
        else:
            argv += ["--lat", str(v["lat"]), "--lon", str(v["lon"]),
                     "--time", v["time"],
                     "--init-view-orientation", v["view_orientation"]]
        for flag, val in (("--elevation-file", v["elevation_file"]),
                          ("--color-file", v["color_file"]),
                          ("--starmap-file", v["starmap_file"]),
                          ("--features-file", v["features_file"])):
            if val:
                argv += [flag, val]
        if v["parallactic_mode"] and not v["init_view"]:
            argv.append("--parallactic-mode")

        run_btn.config(state=tk.DISABLED)
        status_var.set("Renderer running...")
        # separate process: the renderer owns the card and its own Tk loop
        # (reference main_gui_launcher.py:782-813 child + monitor thread),
        # spawned so that it starts with no inherited CUDA state
        proc = multiprocessing.get_context("spawn").Process(
            target=_renderer_child, args=(argv,))
        proc.start()

        def monitor():
            proc.join()
            root.after(0, lambda: (run_btn.config(state=tk.NORMAL),
                                   status_var.set("Renderer exited.")))

        threading.Thread(target=monitor, daemon=True).start()

    run_btn.config(command=on_run)
    root.mainloop()


if __name__ == "__main__":
    run_launcher()
