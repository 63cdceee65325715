"""Command-line entry point (torch port of moonrtx_tpu/app/cli.py).

Flag-for-flag the reference's CLI: the same options, dests and defaults
(the data files default to this package's data directory, or to
MOONRTX_TPU_DATA as in the reference), the same RenderConfig, the same
--init-view restore and first-run data downloads (procedural synthesis
when a file is missing or cannot be fetched). What differs:

* the accelerator is the CUDA card (check_accelerator);
* MOONRTX_PLATFORM (``cpu`` or ``cuda``; unset = the card) picks the
  device the render runs on;
* without a card, unless MOONRTX_PLATFORM=cpu asks for the CPU, main
  prints the error and exits 1, where the reference warns and renders on
  the CPU: the port never falls back to the CPU unasked;
* no compile cache: the CUDA kernels build at first use into
  build/kernels/ (moonrtx_tpu_torch.kernels).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import urllib.parse
import urllib.request
from datetime import datetime
from typing import Optional

from moonrtx_tpu_torch import APP_NAME
from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.app import codec
from moonrtx_tpu_torch.config import ConfigError, RenderConfig
from moonrtx_tpu_torch.orientation import NSWE, SNEW, VIEW_ORIENTATIONS
from moonrtx_tpu_torch.types import Camera, Observer

BASE_PATH = os.path.dirname(os.path.dirname(__file__))
DATA_DIRECTORY_PATH = os.environ.get(
    "MOONRTX_TPU_DATA", os.path.join(BASE_PATH, "data"))

ELEVATION_FILE_NAME = "Lunar_LRO_LOLA_Global_LDEM_118m_Mar2014.tif"
ELEVATION_FILE_LOCAL = os.path.join(DATA_DIRECTORY_PATH, ELEVATION_FILE_NAME)
ELEVATION_FILE_URL = "http://planetarymaps.usgs.gov/mosaic/" + ELEVATION_FILE_NAME
ELEVATION_FILE_SIZE_BYTES = int(7.91 * 1024**3)

STARMAP_FILE_NAME = "starmap_16k.tif"
STARMAP_FILE_LOCAL = os.path.join(DATA_DIRECTORY_PATH, STARMAP_FILE_NAME)
STARMAP_FILE_URL = ("https://svs.gsfc.nasa.gov/vis/a000000/a003800/a003895/"
                    + STARMAP_FILE_NAME)
STARMAP_FILE_SIZE_BYTES = int(132 * 1024**2)

COLOR_FILE_LOCAL = os.path.join(DATA_DIRECTORY_PATH, "moon_color_10k_8bit.tif")
COLOR_FILE_GDRIVE_ID = "1gJeVic597BUAkpz1GgCYRMJVninKEDKB"
COLOR_FILE_SIZE_BYTES = int(71.3 * 1024**2)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=f"{APP_NAME} - ray-traced Moon observatory on a CUDA "
                    "card",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--lat", type=float, default=None,
                        help="Observer latitude in degrees. Examples: 50.0614 "
                             "(Cracow, Poland), -34.6131 (Buenos Aires). "
                             "Mandatory unless --init-view is used.")
    parser.add_argument("--lon", type=float, default=None,
                        help="Observer longitude in degrees. Mandatory unless "
                             "--init-view is used.")
    parser.add_argument("--elevation", type=int, default=0,
                        help="Observer elevation above sea level in meters.")
    parser.add_argument("--time", type=str, default="now",
                        help="ISO time with timezone, e.g. 2024-01-01T12:00:00Z "
                             "or 2025-12-26T16:30:00+01:00")
    parser.add_argument("--elevation-file", type=str, default=ELEVATION_FILE_LOCAL,
                        help="Path to Moon elevation map (LOLA LDEM TIFF)")
    parser.add_argument("--color-file", type=str, default=COLOR_FILE_LOCAL,
                        help="Path to Moon color map file")
    parser.add_argument("--starmap-file", type=str, default=STARMAP_FILE_LOCAL,
                        help="Path to star map TIFF for the background")
    parser.add_argument("--features-file", type=str, default=None,
                        help="Path to a lunar feature CSV (reference format); "
                             "defaults to the built-in catalog")
    parser.add_argument("--downscale", type=int, default=3,
                        help="Elevation downscale factor; 1 keeps full "
                             "resolution (served through mip levels)")
    parser.add_argument("--synth-shape", type=str, default=None,
                        metavar="HxW",
                        help="Target grid for the procedural elevation "
                             "fallback when no real data files exist, "
                             "e.g. 23040x46080 (the LOLA LDEM working "
                             "set at --downscale 2). Streamed and "
                             "disk-cached; default keeps the base "
                             "synthesis grid")
    parser.add_argument("--brightness", type=int, default=80, help="Brightness")
    parser.add_argument("--gamma", type=float, default=2.2,
                        help="Gamma correction value (0.5 - 5.0)")
    parser.add_argument("--parallactic-mode", action="store_true",
                        help="Keep the Moon aligned to celestial north")
    parser.add_argument("--time-step-minutes", type=int, default=15,
                        help="Time step in minutes for Q/W keys")
    parser.add_argument("--init-view", type=str, default=None,
                        help="Restore a view from a screenshot default filename "
                             "(without extension)")
    parser.add_argument("--init-view-orientation", type=str, default=NSWE,
                        help=f"View orientation (e.g. {SNEW} for a refractor). "
                             f"Valid: {', '.join(VIEW_ORIENTATIONS)}")
    parser.add_argument("--shadow-accuracy", type=int, default=1,
                        help="Shadow accuracy factor (1-20): scales the "
                             "terminator shadow-scan resolution; X toggles "
                             "exact shadows at runtime")
    # engine extensions
    parser.add_argument("--width", type=int, default=1920, help="Render width")
    parser.add_argument("--height", type=int, default=1080, help="Render height")
    parser.add_argument("--backend", type=str, default="auto",
                        help="Render backend: auto | blocked | reference | pallas")
    parser.add_argument("--photometric", type=str, default="lambert",
                        help="Surface photometric function: lambert "
                             "(reference-matching diffuse) | lunar "
                             "(McEwen lunar-Lambert — the real regolith's "
                             "flat-bright full-Moon look)")
    parser.add_argument("--no-eclipse-shading", action="store_true",
                        help="Disable physical lunar-eclipse shading "
                             "(umbra/penumbra + red refracted light); "
                             "matches the reference, which renders an "
                             "ordinary full Moon during eclipses")
    parser.add_argument("--no-earthshine", action="store_true",
                        help="Disable earthshine (the da Vinci glow on "
                             "the crescent Moon's night side); matches "
                             "the reference's pure-black night side")
    parser.add_argument("--headless", action="store_true",
                        help="Render one view to an image file and exit")
    parser.add_argument("--timelapse-frames", type=int, default=1,
                        help="With --headless: render this many frames "
                             "stepping --time-step-minutes between them "
                             "(saved as <stem>_NNNN.png)")
    parser.add_argument("--save", type=str, default=None,
                        help="Output path for --headless (default: the "
                             "view-state filename + .png)")
    parser.add_argument("--accumulation-frames", type=int, default=8,
                        help="Accumulation samples per still frame")
    parser.add_argument("--no-download", action="store_true",
                        help="Never attempt data downloads; use local files "
                             "or procedural synthesis")
    parser.add_argument("--no-indirect-light", action="store_true",
                        help="Disable one-bounce terrain interreflection "
                             "(the analog of the reference's path-traced "
                             "indirect segments)")
    parser.add_argument("--indirect-bounces", type=int, default=1,
                        choices=(1, 2),
                        help="Deterministic terrain bounces (2 = the "
                             "reference's full two-segment depth; the "
                             "second bounce is ~5%% of the indirect term "
                             "— docs/GI.md)")
    parser.add_argument("--devices", type=int, default=1,
                        help="Device-mesh width for multi-device rendering "
                             "(image strips, shadow-scan wedges): 1 = single "
                             "device, 0 = every local card, N = exactly N "
                             "(fails if fewer cards exist)")
    parser.add_argument("--hbm-budget-gb", type=float, default=0.0,
                        help="Per-chip HBM budget (GiB) for the map "
                             "pyramids with --devices > 1: maps that "
                             "exceed it are band-sharded across the mesh "
                             "instead of replicated (the non-destructive "
                             "replacement for --downscale). 0 = use the "
                             "device's reported memory limit")
    return parser.parse_args(argv)


def _download(url: str, dest: str) -> None:
    opener = urllib.request.build_opener()
    opener.addheaders = [("User-Agent", APP_NAME)]
    urllib.request.install_opener(opener)
    urllib.request.urlretrieve(url, dest)


def _download_google_drive(file_id: str, dest: str) -> None:
    """Fetch a public Google Drive file, following the interstitial
    virus-scan confirmation for large files (the reference hosts its color
    map on Drive, main.py:135-152)."""
    import http.cookiejar
    import re

    jar = http.cookiejar.CookieJar()
    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(jar))
    opener.addheaders = [("User-Agent", APP_NAME)]
    url = f"https://drive.google.com/uc?export=download&id={file_id}"
    with opener.open(url) as resp:
        head = resp.read(64 * 1024)
        ctype = resp.headers.get("Content-Type", "")
        if "text/html" not in ctype:
            with open(dest + ".part", "wb") as f:
                f.write(head)
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            os.replace(dest + ".part", dest)
            return
    # interstitial page: extract the confirm form fields
    page = head.decode("utf-8", "replace")
    fields = dict(re.findall(
        r'name="([^"]+)"\s+value="([^"]*)"', page))
    action = re.search(r'action="([^"]+)"', page)
    base = action.group(1) if action else \
        "https://drive.usercontent.google.com/download"
    query = urllib.parse.urlencode(
        {**fields, "id": file_id, "export": "download"})
    with opener.open(f"{base}?{query}") as resp, \
            open(dest + ".part", "wb") as f:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(dest + ".part", dest)


def check_color_file(path: str, allow_download: bool = True) -> Optional[str]:
    """Usable color-file path or None (procedural fallback), downloading
    the default from its Drive source with a disk-space check like the
    reference (main.py:135-152)."""
    if os.path.isfile(path):
        return path
    if path != COLOR_FILE_LOCAL or not allow_download:
        print(f"Color file not found: {path} — using procedural synthesis.")
        return None
    _, _, free = shutil.disk_usage(os.getcwd())
    if free < COLOR_FILE_SIZE_BYTES * 1.02:
        print("Not enough disk space to download the color file "
              f"({COLOR_FILE_SIZE_BYTES / 1024**2:.1f} MB required) — using "
              "procedural synthesis.")
        return None
    print(f"Downloading color file ({COLOR_FILE_SIZE_BYTES / 1024**2:.0f} MB)."
          " Done only once.")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _download_google_drive(COLOR_FILE_GDRIVE_ID, path)
        return path
    except Exception as e:
        print(f"Error downloading color file: {e} — using procedural "
              "synthesis.")
        return None


def _check_file(path: str, default_path: str, url: Optional[str],
                size_bytes: int, label: str, allow_download: bool) -> Optional[str]:
    """Return a usable path or None (procedural fallback).

    Mirrors the reference's disk-space-checked first-run downloads
    (main.py:101-152) but degrades gracefully instead of exiting."""
    if os.path.isfile(path):
        return path
    if path != default_path or url is None or not allow_download:
        print(f"{label} file not found: {path} — using procedural synthesis.")
        return None
    _, _, free = shutil.disk_usage(os.getcwd())
    if free < size_bytes * 1.02:
        print(f"Not enough disk space to download the {label} file "
              f"({size_bytes / 1024**3:.2f} GB required) — using procedural "
              "synthesis.")
        return None
    print(f"Downloading {label} file ({size_bytes / 1024**2:.0f} MB). "
          "Done only once.")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _download(url, path)
        return path
    except Exception as e:
        print(f"Error downloading {label} file: {e} — using procedural "
              "synthesis.")
        return None


def config_from_args(args) -> RenderConfig:
    initial_camera: Optional[Camera] = None
    view_orientation = args.init_view_orientation.upper()
    parallactic_mode = args.parallactic_mode
    lat, lon = args.lat, args.lon

    if args.init_view:
        iv = codec.parse_init_view(args.init_view)
        if iv is None:
            print(f"Error: Could not parse --init-view value: {args.init_view}")
            sys.exit(1)
        dt_local = iv.dt_local
        lat, lon = iv.lat, iv.lon
        view_orientation = iv.view_orientation
        parallactic_mode = iv.parallactic_mode
        initial_camera = iv.camera
    else:
        time_iso = (datetime.now().astimezone().isoformat(timespec="seconds")
                    if args.time == "now" else args.time)
        dt_local, err = codec.parse_iso_datetime(time_iso)
        if err is not None:
            print(f"Incorrect time: {err}")
            sys.exit(1)
        if lat is None:
            print("Error: --lat parameter is mandatory.")
            sys.exit(1)
        if lon is None:
            print("Error: --lon parameter is mandatory.")
            sys.exit(1)

    def _parse_synth_shape(s):
        if not s:
            return None
        try:
            h, w = (int(v) for v in s.lower().split("x"))
            return (h, w)
        except ValueError:
            print("Error: --synth-shape must be HxW, e.g. 23040x46080.")
            sys.exit(1)

    allow_dl = not args.no_download
    elevation_file = _check_file(args.elevation_file, ELEVATION_FILE_LOCAL,
                                 ELEVATION_FILE_URL, ELEVATION_FILE_SIZE_BYTES,
                                 "elevation", allow_dl)
    color_file = check_color_file(args.color_file, allow_download=allow_dl)
    starmap_file = _check_file(args.starmap_file, STARMAP_FILE_LOCAL,
                               STARMAP_FILE_URL, STARMAP_FILE_SIZE_BYTES,
                               "star map", allow_dl)

    cfg = RenderConfig(
        observer=Observer(lat, lon, args.elevation),
        dt_local=dt_local,
        elevation_file=elevation_file,
        color_file=color_file,
        starmap_file=starmap_file,
        features_file=args.features_file,
        downscale=args.downscale,
        synth_shape=_parse_synth_shape(args.synth_shape),
        brightness=args.brightness,
        gamma=args.gamma,
        time_step_minutes=args.time_step_minutes,
        view_orientation=view_orientation,
        parallactic_mode=parallactic_mode,
        shadow_accuracy=args.shadow_accuracy,
        initial_camera=initial_camera,
        width=args.width,
        height=args.height,
        backend=args.backend,
        accumulation_frames=args.accumulation_frames,
        indirect_light=not args.no_indirect_light,
        indirect_bounces=args.indirect_bounces,
        devices=args.devices,
        hbm_budget_gb=args.hbm_budget_gb,
        photometric=args.photometric,
        eclipse_shading=not args.no_eclipse_shading,
        earthshine=not args.no_earthshine,
    )
    try:
        cfg.validate()
    except ConfigError as e:
        print(str(e))
        sys.exit(1)
    return cfg


def print_startup(cfg: RenderConfig) -> None:
    """Startup parameter echo (reference moon_renderer.py:738-754)."""
    print()
    print(f"{APP_NAME} renderer started with parameters:")
    o = cfg.observer
    print(f"  Observer Location: Lat {o.lat}°, Lon {o.lon}°, "
          f"Elevation {o.elevation_m} m")
    print(f"  Local Time: {cfg.dt_local}")
    print(f"  Elevation File: {cfg.elevation_file or '(procedural)'}")
    print(f"  Color File: {cfg.color_file or '(procedural)'}")
    print(f"  Brightness: {cfg.brightness}")
    print(f"  Gamma: {cfg.gamma}")
    print(f"  Downscale Factor: {cfg.downscale}")
    print(f"  Time Step (minutes): {cfg.time_step_minutes}")
    print(f"  Initial View Orientation: {cfg.view_orientation}")
    print(f"  Parallactic Mode: {'ON' if cfg.parallactic_mode else 'OFF'}")
    print(f"  Shadow Accuracy: {cfg.shadow_accuracy}")
    print(f"  Backend: {cfg.backend}")
    if cfg.photometric != "lambert":
        print(f"  Photometric: {cfg.photometric}")
    if cfg.initial_camera is not None:
        print("  Location, time and view set from --init-view parameter value")
    print()


PLATFORMS = ("cpu", "cuda")


def check_accelerator(device=None) -> bool:
    """Report the device the render runs on (the reference reports its JAX
    backend). The CUDA card unless ``device`` is "cpu"; without a card,
    print the error and return False instead of falling back to the CPU."""
    import torch

    if device == "cpu":
        print("Accelerator: cpu (MOONRTX_PLATFORM=cpu)")
        return True
    if not torch.cuda.is_available():
        print("Error: no CUDA device is available. Set MOONRTX_PLATFORM=cpu "
              "to render on the CPU.")
        return False
    print(f"Accelerator: cuda ({torch.cuda.get_device_name(0)}"
          f" x{torch.cuda.device_count()})")
    return True


def check_devices(cfg: RenderConfig, device=None) -> bool:
    """Build the device mesh that --devices asks for, as the scene will,
    and report it; on a host with fewer cards print make_mesh's error and
    return False (nothing renders on fewer devices than asked)."""
    import torch

    from moonrtx_tpu_torch.engine.scene import resolve_mesh

    dev = torch.device("cpu" if device == "cpu" else "cuda")
    try:
        mesh = resolve_mesh(cfg, dev)
    except RuntimeError as e:
        print(f"Error: {e}")
        return False
    if mesh is not None:
        print(f"Devices: {mesh.size} "
              f"({', '.join(str(d) for d in mesh.devices)})")
    return True


def main(argv=None):
    # MOONRTX_PLATFORM picks the device: "cpu" or "cuda"; unset means the
    # card
    device = os.environ.get("MOONRTX_PLATFORM") or None
    if device is not None and device not in PLATFORMS:
        print(f"Error: MOONRTX_PLATFORM must be one of {', '.join(PLATFORMS)}"
              f", not {device!r}.")
        sys.exit(1)
    args = parse_args(argv)
    cfg = config_from_args(args)
    if not check_accelerator(device) or not check_devices(cfg, device):
        sys.exit(1)
    print_startup(cfg)

    if args.headless:
        if args.timelapse_frames > 1:
            from moonrtx_tpu_torch.app.headless import render_timelapse
            render_timelapse(cfg, args.save, args.timelapse_frames,
                             n_frames=args.accumulation_frames, device=device)
        else:
            from moonrtx_tpu_torch.app.headless import render_headless
            render_headless(cfg, save_path=args.save,
                            n_frames=args.accumulation_frames, device=device)
        return

    from moonrtx_tpu_torch.app.window import run_window
    run_window(cfg, device=device)


if __name__ == "__main__":
    main()
