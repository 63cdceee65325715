#!/usr/bin/env python3
"""The command-line time-lapse of one or more checkouts, timed save by save.

    python3 tools/torch_cli_timelapse.py [--frames 4] [--synth-shape
                                         11520x23040] ROOT [ROOT ...]

Each ROOT holds a ``moonrtx_tpu_torch`` package (the repository root, or
a ``git archive`` of another commit unpacked under ``build/``). From each,
in the order given, runs chip_smoke.py phase 7's time-lapse command
(``python -m moonrtx_tpu_torch --headless --backend pallas
--accumulation-frames 32 --timelapse-frames N`` at 1920x1080, shadow
accuracy 10, on the synthetic map) and prints one JSON line: the exit
code, the wall time, the seconds of the first ``Saved:`` line, the
intervals between successive ``Saved:`` lines (ms) and the peak host RSS.
The first ROOT runs once more before the others to build the kernels and
warm the map caches (``build/cli_cache``). Give the roots in turns
(parent, change, change, parent): the host sets these intervals, and it
differs from call to call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--synth-shape", default="11520x23040")
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from chip_smoke import run_cli

    out_dir = os.path.join(HERE, "build", "cli_timelapse")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, MOONRTX_TPU_CACHE=os.path.join(
        HERE, "build", "cli_cache"))
    env.pop("MOONRTX_PLATFORM", None)
    print("# card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    flags = ["--lat", "50.06", "--lon", "19.94", "--elevation", "219",
             "--time", "2024-04-15T21:00:00Z", "--synth-shape",
             args.synth_shape, "--downscale", "1", "--shadow-accuracy", "10",
             "--devices", "0", "--headless", "--no-download", "--backend",
             "pallas", "--accumulation-frames", "32", "--indirect-bounces",
             "1", "--timelapse-frames", str(args.frames),
             "--save", os.path.join(out_dir, "tl.png")]
    for i, root in enumerate([args.roots[0]] + args.roots):
        r = run_cli(flags, os.path.abspath(root), env, 900)
        saved = [t for t, line in r["lines"] if line.startswith("Saved: ")]
        rec = dict(root=os.path.relpath(os.path.abspath(root), HERE),
                   run="warm-up" if i == 0 else i, rc=r["rc"],
                   wall_s=r["wall_s"], first_save_s=saved[0] if saved
                   else None,
                   intervals_ms=[(b - a) * 1e3
                                 for a, b in zip(saved, saved[1:])],
                   rss_gib=r["rss_gib"])
        print(json.dumps(rec), flush=True)
        if r["rc"] != 0:
            print("\n".join(line for _, line in r["lines"][-30:]))
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
