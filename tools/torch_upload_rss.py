#!/usr/bin/env python3
"""Host peak RSS of the port's scene set-up, for one or more checkouts.

    python3 tools/torch_upload_rss.py [--synth-shape 23040x46080]
                                      [--device cuda|cpu] ROOT [ROOT ...]

Each ROOT is a directory that holds a ``moonrtx_tpu_torch`` package (the
repository root, or a ``git archive`` of another commit unpacked under
``build/``). For each, in the order given, a fresh Python process run
from ROOT calls ``app.headless.build_scene`` on chip_smoke.py's main-path
configuration at the given synthetic map size (1920x1080, shadow accuracy
10, downscale 1) and prints one JSON line: the process's peak host RSS
(``ru_maxrss``), the set-up wall time (synchronised) and the scene's own
upload time. The first ROOT runs once more before the others to warm the
synthetic map and pyramid caches (``build/rss_cache``), so every counted
run loads the same memory-mapped caches. Give the roots in turns (parent,
change, change, parent) to see the spread.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, resource, sys, time
from datetime import datetime, timezone
import torch
sys.path.insert(0, '.')
from moonrtx_tpu_torch.app import headless
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.types import Observer
th, tw = (int(v) for v in sys.argv[1].split('x'))
cfg = RenderConfig(
    observer=Observer(50.06, 19.94, 219),
    dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
    width=1920, height=1080, shadow_accuracy=10, backend='pallas',
    synth_shape=(th, tw), downscale=1).validate()
t0 = time.time()
scene = headless.build_scene(cfg, device=sys.argv[2])
if scene.device.type == 'cuda':
    torch.cuda.synchronize()
print(json.dumps(dict(
    rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    setup_s=time.time() - t0, upload_s=scene.upload_wall_s,
    map=list(scene.mip_shapes[0]), dtype=str(scene.mips[0].dtype))))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synth-shape", default="23040x46080")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args(argv)

    env = dict(os.environ, MOONRTX_TPU_CACHE=os.path.join(
        HERE, "build", "rss_cache"))
    if args.device == "cuda":
        print("# card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    print(f"# host: {os.cpu_count()} cores", flush=True)
    for i, root in enumerate([args.roots[0]] + args.roots):
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, "-c", CHILD, args.synth_shape, args.device],
            cwd=root, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:])
            raise SystemExit(f"the run in {root} exited {out.returncode}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["root"] = os.path.relpath(root, HERE)
        rec["run"] = "warm-up" if i == 0 else i
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
