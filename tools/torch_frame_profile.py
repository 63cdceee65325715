#!/usr/bin/env python3
"""Where a 1080p frame of the PyTorch/CUDA port spends its time, on one card.

    python3 tools/torch_frame_profile.py [--synth-shape 11520x23040]
                                         [--backend pallas|blocked|reference]

Builds chip_smoke.py's main-path scene (1920x1080, shadow accuracy 10,
synthetic LOLA-sized int16 map) on the chosen backend: "pallas" (the
march kernel, 32 samples in a burst; the default), "blocked" (per-block
windows cut by K5, march and shading in plain torch ops, 8 samples one at
a time) or "reference" (plain gathers; resolves to "blocked" on this
quantized map). Renders the first frame, then measures with
torch.cuda.synchronize() between stages:

* a steady cold frame: a one-minute time step with the cached bounce map
  dropped (a minute moves the sun far less than the scene's bounce-reuse
  angle), so the next render runs what the main path's first frame runs:
  the shadow scan + bounce pyramid, the pose program (window origins,
  extraction, packing) and the 32-sample burst;
* its stages: the scan + bounce pyramid alone, then the pose program;
* the warm re-burst (same pose, cached windows), per sample; on the
  blocked backend the same samples one at a time from the cached windows;

and traces one steady cold frame with torch.profiler, printing the device
time by kernel name, the device busy time and the idle share of the
frame's wall time. Writes the chrome trace to chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synth-shape", default="11520x23040")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "blocked", "reference"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = os.path.join(HERE, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    os.environ["MOONRTX_TPU_CACHE"] = os.path.join(out_dir, "cache")
    sys.path.insert(0, HERE)
    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.types import Observer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"# card: {card}")
    th, tw = (int(v) for v in args.synth_shape.split("x"))
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=1920, height=1080, shadow_accuracy=10, backend=args.backend,
        synth_shape=(th, tw), downscale=1).validate()
    scene = headless.build_scene(cfg)
    scene.update_view()
    n = 32 if scene.backend == "pallas" else 8
    print(f"# backend {args.backend} -> {scene.backend}, {n} samples")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    first = timed(lambda: scene.render(n))
    print(f"# first frame (process cold): {first:.1f} ms")

    def step():
        # a time step with the pose caches and the bounce map dropped (a
        # one-minute step alone keeps the windows: drift reuse)
        scene.update_view(scene.dt_local + timedelta(minutes=1))
        scene.set_view_orientation(scene.view_orientation)
        scene._bounce = None

    for rep in range(3):
        step()
        cold = timed(lambda: scene.render(n))
        step()
        scan = timed(scene.shadow_args)
        pose = timed(lambda: scene.render(n))
        scene.reset_accumulation()
        warm = timed(lambda: scene.ensure_accumulated(n))
        print(f"# rep {rep}: steady cold frame {cold:.2f} ms = scan+bounce "
              f"{scan:.2f} ms + pose program and burst {pose:.2f} ms; warm "
              f"re-burst {warm:.2f} ms ({warm / n:.3f} ms per sample)")

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scene.render(n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = os.path.join(out_dir, "frame_trace.json")
    prof.export_chrome_trace(trace)
    # device-side events only (kernels and copies), grouped by name, so a
    # kernel is not counted again under the CPU op that launched it
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), cnt + 1)
    rows = sorted(((us, cnt, name) for name, (us, cnt) in by_name.items()),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"# traced steady cold frame: wall {wall_ms:.2f} ms (profiler "
          f"on), device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for dev_us, count, key in rows[:20]:
        print(f"#   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    print(f"# trace: {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
