#!/usr/bin/env python3
"""Device time of the shadow scan's two kernels (K3, K4) at the main
path's shapes, without building a scene.

    python3 tools/torch_kernel_tune.py [--root DIR] [--reps 50]

Runs one accuracy-10 sun scan (``build_shadow_and_bounce``: a (1536, 4096)
grid, 12,288 height blocks on int16 levels, 3,072 half-resolution albedo
blocks on f32 levels) over an 11520x23040 map of random texels made on the
card: the scan's geometry, and so every window origin and sample
coordinate, is the main path's, and neither kernel's time depends on the
texel values. It records the kernel launches the scan makes and replays
each ``--reps`` times; the time is the sum of torch.profiler's device
events of a replay, over the replays (no host time). K3 is replayed at
every chunk height its kernel takes, and also on the (2304, 4096) grid of
accuracy 18.

``--root`` names another checkout (say, the parent commit unpacked with
``git archive``) whose ``moonrtx_tpu_torch`` is timed instead, so two
designs can be compared within one call on one card: run it in turns
(parent, change, change, parent). Prints one JSON object per line, the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of all device kernels one call of fn launches
    (a window in which the profiler lost an event is measured again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
        if us and len(us) % reps == 0:
            return sum(us) / reps / 1e3
    raise SystemExit(f"the profiler saw {len(us)} device events in {reps} "
                     "calls")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--root", default=here,
                    help="checkout whose moonrtx_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.ops import extract, shadow_prefix, shadow_scan

    tag = os.path.basename(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"root": tag, "card": card}), flush=True)
    kernels.build_all()
    for src in ("shadow_prefix", "resample"):
        regs = [ln.split(":", 1)[1].strip() for ln in
                kernels.build_log.get(src, "").splitlines()
                if "registers" in ln]
        print(json.dumps({"root": tag, "source": src, "ptxas": regs}),
              flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, w = 11520, 23040
    tex = torch.randint(-2000, 2000, (h, w + 192), generator=gen,
                        device="cuda", dtype=torch.int16)
    alb = torch.rand((h, w + 192), generator=gen, device="cuda")
    sun = torch.tensor([0.6, -0.7, 0.3], device="cuda")
    sun = sun / torch.linalg.norm(sun)
    with kernels.recording() as calls:
        shadow_scan.build_shadow_and_bounce(tex, alb, h, w, sun, 0.0046,
                                            accuracy=10, h_scale=2.5e-5,
                                            h_offset=0.9)
    torch.cuda.synchronize()
    for name, call in calls:
        if name == "resample_group_windows":
            ms = device_ms(lambda: extract.resample_group_windows(**call),
                           args.reps)
            print(json.dumps({
                "root": tag, "kernel": name,
                "dtype": str(call["levels"][0].dtype),
                "blocks": call["wy"].shape[0], "ms": ms}), flush=True)
        elif name == "shadow_factor":
            big = dict(call, hs=call["hs"].repeat(2, 1)[:2304].contiguous(),
                       st=call["st"].repeat(2, 1)[:2304].contiguous(),
                       ct=call["ct"].repeat(2, 1)[:2304].contiguous())
            heights = (16, 32, 64) if hasattr(shadow_prefix, "CHUNK_ROWS") \
                else (None,)
            for rows in heights:
                if rows is not None:
                    shadow_prefix.CHUNK_ROWS = rows
                for c in (call, big):
                    ms = device_ms(lambda: shadow_prefix.shadow_factor(**c),
                                   args.reps)
                    print(json.dumps({
                        "root": tag, "kernel": name, "chunk_rows": rows,
                        "grid": list(c["hs"].shape), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
