"""Launcher presets and coordinate parsing (display-free logic).

JSON presets mirror the reference GUI launcher's preset files
(reference main_gui_launcher.py:349-543); sexagesimal coordinate entry
follows its D/M/S + N/S/E/W form semantics (main_gui_launcher.py:137-347).
"""

from __future__ import annotations

import json
import os
from typing import Optional

PRESET_KEYS = [
    "lat", "lon", "elevation", "time", "utc_offset", "downscale",
    "brightness", "gamma", "time_step_minutes", "view_orientation",
    "parallactic_mode", "shadow_accuracy", "elevation_file", "color_file",
    "starmap_file", "features_file", "init_view",
    "backend", "width", "height",
    "photometric", "eclipse_shading", "earthshine",
    "devices", "hbm_budget_gb",
]


def sexagesimal_to_decimal(degrees: float, minutes: float, seconds: float,
                           hemisphere: str) -> float:
    """D/M/S + hemisphere letter -> signed decimal degrees."""
    value = abs(degrees) + minutes / 60.0 + seconds / 3600.0
    if hemisphere.upper() in ("S", "W"):
        value = -value
    return value


def decimal_to_sexagesimal(value: float, is_latitude: bool
                           ) -> tuple[int, int, float, str]:
    """Signed decimal degrees -> (D, M, S, hemisphere letter)."""
    hemi = ("N" if value >= 0 else "S") if is_latitude else (
        "E" if value >= 0 else "W")
    v = abs(value)
    d = int(v)
    m = int((v - d) * 60)
    s = round((v - d - m / 60.0) * 3600.0, 3)
    return d, m, s, hemi


def utc_offsets() -> list[str]:
    """-12:00 .. +14:00 in 30-minute steps (reference
    main_gui_launcher.py:30-34)."""
    out = []
    for half_hours in range(-24, 29):
        total = half_hours * 30
        sign = "-" if total < 0 else "+"
        a = abs(total)
        out.append(f"{sign}{a // 60:02d}:{a % 60:02d}")
    return out


def preset_dir(base: Optional[str] = None) -> str:
    d = base or os.path.join(os.getcwd(), "presets")
    os.makedirs(d, exist_ok=True)
    return d


def save_preset(name: str, values: dict, base: Optional[str] = None) -> str:
    """Write a named preset; unknown keys are dropped, missing ones allowed."""
    path = os.path.join(preset_dir(base), f"{name}.json")
    data = {k: values[k] for k in PRESET_KEYS if k in values}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2)
    return path


def load_preset(name: str, base: Optional[str] = None) -> Optional[dict]:
    path = os.path.join(preset_dir(base), f"{name}.json")
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except Exception:
        return None
    return {k: v for k, v in data.items() if k in PRESET_KEYS}


def list_presets(base: Optional[str] = None) -> list[str]:
    d = preset_dir(base)
    return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                  if f.endswith(".json"))
