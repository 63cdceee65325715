"""Interactive Tk window: a thin display shell over app.session.Session
(torch port of moonrtx_tpu/app/window.py).

A plain Tk canvas fed by Session.frame's host array. All behavior lives
in Session (display-free, tested); this module only owns the event loop,
dialogs, the status bar and the ephemeris info panel. The scene is built
on ``device`` (None = the CUDA card).
"""

from __future__ import annotations

import os
import webbrowser
from datetime import datetime
from typing import Optional

import numpy as np

from moonrtx_tpu_torch import APP_NAME
from moonrtx_tpu_torch.app.headless import build_scene, save_image
from moonrtx_tpu_torch.app.session import Session
from moonrtx_tpu_torch.config import RenderConfig

HELP_TEXT = """\
F1   Help                         F2   Toggle ephemeris panel
F4   Toggle parallactic mode      F5-F8  View orientations (NSWE/NSEW/SNEW/SNWE)
F9   Set time to now              F10  Now + auto-advance
F12  Save image                   1-9  Create/remove pin at cursor
G    Selenographic grid           L    Standard labels
S    Spot labels                  P    Pins on/off
R    Reset view and time          V    Default view for current time
C    Center on cursor             F    Search features
I    Open USGS page               O    Open feature web page
T    Date/time window             X    Exact terminator shadows
A/Z  Brightness +/-               E/D  Gamma +/-
H/J  Roll view                    Q/W  Time back/forward (hold = animate)
M/N  Time step +/-1 (Shift: 60)   Arrows  Move view
Ctrl+Arrows  Rotate around Moon axes
Left-drag    Rotate eye around Moon (orbit)
Right-drag   Pan/tilt view
Shift+Left-drag up/down   Zoom out/in
Shift+Right-drag up/down  Move eye backward/forward
Ctrl+Left-drag  Measure distance and elevation difference
Wheel        Zoom
"""


def run_window(config: RenderConfig, device=None) -> None:
    import tkinter as tk
    from PIL import Image, ImageTk

    scene = build_scene(config, device=device)
    session = Session(scene, scene.features)

    root = tk.Tk()

    def refresh_title():
        o = config.observer
        root.title(f"{APP_NAME} - lat {o.lat:.4f} lon {o.lon:.4f} - "
                   f"{scene.dt_local:%Y-%m-%d %H:%M %Z}")

    refresh_title()
    w, h = scene.out_width, scene.out_height
    canvas = tk.Canvas(root, width=w, height=h, bg="black",
                       highlightthickness=0)
    canvas.pack(fill=tk.BOTH, expand=True)

    # --- status bar (10 panels, reference renderer_status.py:235-246) ---
    status = tk.Frame(root)
    status.pack(fill=tk.X, side=tk.BOTTOM)
    panel_keys = ["pins", "shadows", "brightness", "gamma", "feature",
                  "coords", "measured", "time", "view", "parallactic", "fps",
                  "memory"]
    panel_vars = {}
    for key in panel_keys:
        var = tk.StringVar()
        # the "memory" panel carries the HBM-over-budget warning (empty
        # in normal operation) — red so it reads as a warning
        tk.Label(status, textvariable=var, relief=tk.SUNKEN, anchor="w",
                 padx=4, **({"fg": "#cc2222"} if key == "memory" else {})
                 ).pack(side=tk.LEFT, fill=tk.X, expand=(key == "feature"))
        panel_vars[key] = var
    auto_advance_var = tk.BooleanVar(value=False)
    tk.Checkbutton(status, text="▶", variable=auto_advance_var).pack(
        side=tk.RIGHT)

    # --- ephemeris info panel (reference renderer_status.py:294-340) ---
    info = tk.Frame(canvas, bg="#111111")
    info_vars = []

    def rebuild_info():
        for child in info.winfo_children():
            child.destroy()
        info_vars.clear()
        for name, value in session.info_panel():
            row = tk.Frame(info, bg="#111111")
            row.pack(fill=tk.X)
            tk.Label(row, text=name + ":", fg="#999999", bg="#111111",
                     width=12, anchor="w").pack(side=tk.LEFT)
            var = tk.StringVar(value=value)
            tk.Label(row, textvariable=var, fg="#dddddd",
                     bg="#111111", anchor="w").pack(side=tk.LEFT)
            info_vars.append((name, var))

    def update_info():
        if not session.show_info_panel:
            info.place_forget()
            return
        info.place(x=8, rely=1.0, y=-8, anchor="sw")
        rows = dict(session.info_panel())
        for name, var in info_vars:
            var.set(rows.get(name, ""))

    rebuild_info()

    state = {"photo": None, "accum_target": config.accumulation_frames,
             "measuring_line": None, "auto_advance_id": None,
             "auto_elapsed": 0, "time_epoch": session.time_epoch}

    def refresh_status():
        panels = session.status_panels()
        for key in panel_keys:
            panel_vars[key].set(panels[key])
        update_info()

    def present():
        img = session.frame(n_accum=min(session.scene._accum_n + 1,
                                        state["accum_target"]))
        pil = Image.fromarray(img)
        state["photo"] = ImageTk.PhotoImage(pil)
        canvas.delete("frame")
        canvas.create_image(0, 0, image=state["photo"], anchor="nw",
                            tags="frame")
        refresh_title()
        refresh_status()
        # keep accumulating in idle time until the budget is reached
        if session.scene._accum_n < state["accum_target"]:
            root.after(1, present)

    def full_redraw():
        # manual time/step changes (keys OR dialogs) restart the
        # auto-advance interval, exactly where the session recorded them
        # (session.time_epoch; reference resets _auto_advance_elapsed
        # inside change_time/change_time_step/now)
        if state["time_epoch"] != session.time_epoch:
            state["time_epoch"] = session.time_epoch
            state["auto_elapsed"] = 0
        present()

    # --- event handlers -----------------------------------------------------

    def on_key(event):
        action = session.handle_key(
            event.keysym, shift=bool(event.state & 0x1),
            ctrl=bool(event.state & 0x4), cursor=(event.x, event.y))

        if action == "save_dialog":
            save_dialog()
        elif action == "search_dialog":
            search_dialog()
        elif action == "help_dialog":
            help_dialog()
        elif action == "datetime_dialog":
            datetime_dialog()
        elif action == "open_usgs":
            open_usgs()
        elif action == "open_www":
            open_www()
        elif action == "start_auto_advance":
            auto_advance_var.set(True)
            schedule_auto_advance()
        full_redraw()

    drag = {"x": 0, "y": 0, "button": None}

    def on_press(event, button):
        drag.update(x=event.x, y=event.y, button=button)
        if button == 1 and (event.state & 0x4):
            if session.start_measurement(event.x, event.y):
                state["measuring_line"] = canvas.create_line(
                    event.x, event.y, event.x, event.y, fill="yellow",
                    width=2, dash=(4, 4))

    def on_motion_pressed(event):
        dx, dy = event.x - drag["x"], event.y - drag["y"]
        if session.measuring:
            canvas.coords(state["measuring_line"], drag["x"], drag["y"],
                          event.x, event.y)
            session.update_measurement(event.x, event.y)
            refresh_status()
            return
        shift = bool(event.state & 0x1)
        if drag["button"] == 1:
            if shift:
                # Shift + left-drag up/down: zoom out/in (reference
                # README's PlotOptiX built-in control)
                session.zoom_drag(dy)
            else:
                # per-pixel Rodrigues orbit of the eye about the target
                session.orbit_drag(dx, dy)
            drag.update(x=event.x, y=event.y)
            full_redraw()
        elif drag["button"] == 3:
            if shift:
                # Shift + right-drag up/down: dolly the eye
                session.dolly(dy)
            else:
                session.pan_tilt(dx, dy)
            drag.update(x=event.x, y=event.y)
            full_redraw()

    def on_release(event):
        if session.measuring:
            session.finish_measurement(event.x, event.y)
            if state["measuring_line"] is not None:
                canvas.delete(state["measuring_line"])
                state["measuring_line"] = None
            refresh_status()
        drag["button"] = None

    def on_motion(event):
        session.pick(event.x, event.y)
        refresh_status()

    def on_wheel(event):
        delta = event.delta if event.delta else (120 if event.num == 4 else -120)
        session.zoom(delta)
        full_redraw()

    # --- dialogs -------------------------------------------------------------

    def save_dialog():
        from tkinter import filedialog
        default = session.screenshot_name()
        path = filedialog.asksaveasfilename(
            initialdir=".", title="Save output as image",
            initialfile=f"{default}.jpg", defaultextension=".jpg",
            filetypes=(("JPEG files", "*.jpg"), ("PNG files", "*.png"),
                       ("TIFF 8-bit files", "*.tif"),
                       ("TIFF 16-bit files", "*.tiff")))
        if path:
            # overlays composite into both depths (frame_and_hdr), so the
            # same F12 save carries the same content at 8 and 16 bits
            img, hdr = session.frame_and_hdr(n_accum=state["accum_target"])
            save_image(img, path, linear_hdr=hdr, gamma=scene.gamma)

    def search_dialog():
        win = tk.Toplevel(root)
        win.title("Search Moon Feature")
        win.geometry("400x300")
        entry_var = tk.StringVar()
        tk.Entry(win, textvariable=entry_var).pack(fill=tk.X, padx=8, pady=8)
        lb = tk.Listbox(win)
        lb.pack(fill=tk.BOTH, expand=True, padx=8, pady=(0, 8))
        matches = []

        def update(*_):
            lb.delete(0, tk.END)
            matches.clear()
            matches.extend(session.lookup.search(entry_var.get()))
            for f in matches:
                lb.insert(tk.END, f"{f.name} ({f.diameter_km:.2f} km)")

        def choose(*_):
            sel = lb.curselection()
            if sel and matches:
                session.center_on_feature(matches[sel[0]])
                win.destroy()
                full_redraw()

        entry_var.trace_add("write", update)
        lb.bind("<Double-Button-1>", choose)
        lb.bind("<Return>", choose)
        win.bind("<Escape>", lambda e: win.destroy())

    def help_dialog():
        win = tk.Toplevel(root)
        win.title("Help - Keys and mouse")
        tk.Label(win, text=HELP_TEXT, justify=tk.LEFT,
                 font=("Consolas", 9)).pack(padx=12, pady=10)
        tk.Button(win, text="Close", command=win.destroy).pack(pady=(0, 8))

    def datetime_dialog():
        win = tk.Toplevel(root)
        win.title("Date/Time")
        dt = scene.dt_local
        date_var = tk.StringVar(value=dt.strftime("%Y-%m-%d"))
        time_var = tk.StringVar(value=dt.strftime("%H:%M:%S"))
        frm = tk.Frame(win, padx=10, pady=8)
        frm.pack()
        tk.Label(frm, text="Date:").grid(row=0, column=0, sticky="e")
        tk.Entry(frm, textvariable=date_var, width=14).grid(row=0, column=1)
        tk.Label(frm, text=f"Local Time (UTC{dt.strftime('%z')}):").grid(
            row=1, column=0, sticky="e")
        tk.Entry(frm, textvariable=time_var, width=14).grid(row=1, column=1)
        err_var = tk.StringVar()
        tk.Label(win, textvariable=err_var, fg="red").pack()

        def apply():
            try:
                try:
                    new = datetime.strptime(
                        f"{date_var.get()} {time_var.get()}",
                        "%Y-%m-%d %H:%M:%S")
                except ValueError:
                    new = datetime.strptime(
                        f"{date_var.get()} {time_var.get()}", "%Y-%m-%d %H:%M")
                session.set_time(new.replace(tzinfo=dt.tzinfo))
                err_var.set("")
                full_redraw()
            except Exception as e:
                err_var.set(f"Error: {e}")

        btns = tk.Frame(win)
        btns.pack(pady=6)
        tk.Button(btns, text="Now", command=lambda: (
            session.set_time_to_now(), full_redraw())).pack(side=tk.LEFT, padx=4)
        tk.Button(btns, text="Set", command=apply).pack(side=tk.LEFT, padx=4)

    def open_usgs():
        f = session.status_feature
        if f is not None and f.feature_id:
            webbrowser.open(
                "https://planetarynames.wr.usgs.gov/Feature/" + str(f.feature_id))

    def open_www():
        f = session.status_feature
        if f is not None and f.www_address:
            url = f.www_address
            if not url.startswith("http"):
                url = "https://" + url
            webbrowser.open(url)

    # --- auto-advance (reference moon_renderer.py:357-399) -------------------

    def schedule_auto_advance():
        if state["auto_advance_id"] is not None:
            root.after_cancel(state["auto_advance_id"])
        state["auto_advance_id"] = root.after(1000, auto_tick)

    def auto_tick():
        if not auto_advance_var.get():
            state["auto_advance_id"] = None
            return
        state["auto_elapsed"] += 1000
        if state["auto_elapsed"] >= session.time_step_minutes * 60 * 1000:
            state["auto_elapsed"] = 0
            session.change_time(session.time_step_minutes)
            full_redraw()
        schedule_auto_advance()

    auto_advance_var.trace_add(
        "write", lambda *_: schedule_auto_advance()
        if auto_advance_var.get() else None)

    # --- bindings -------------------------------------------------------------

    root.bind("<Key>", on_key)
    canvas.bind("<ButtonPress-1>", lambda e: on_press(e, 1))
    canvas.bind("<ButtonPress-3>", lambda e: on_press(e, 3))
    canvas.bind("<B1-Motion>", on_motion_pressed)
    canvas.bind("<B3-Motion>", on_motion_pressed)
    canvas.bind("<ButtonRelease-1>", on_release)
    canvas.bind("<Motion>", on_motion)
    canvas.bind("<MouseWheel>", on_wheel)
    canvas.bind("<Button-4>", on_wheel)
    canvas.bind("<Button-5>", on_wheel)

    present()
    root.mainloop()
