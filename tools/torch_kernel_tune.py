#!/usr/bin/env python3
"""Device time of the port's kernels at the main path's shapes.

    python3 tools/torch_kernel_tune.py [--root DIR] [--reps 50]
                                       [--what scan|extract|all]
                                       [--synth-shape 11520x23040]
                                       [--variants]

``scan`` (K3, K4, no scene): runs one accumulation-10 sun scan
(``build_shadow_and_bounce``: a (1536, 4096) grid, 12,288 height blocks on
int16 levels, 3,072 half-resolution albedo blocks on f32 levels) over an
11520x23040 map of random texels made on the card: the scan's geometry,
and so every window origin and sample coordinate, is the main path's, and
neither kernel's time depends on the texel values. K3 is replayed at
every chunk height its kernel takes, and also on the (2304, 4096) grid of
accuracy 18.

``extract`` (K1, K5): builds ``chip_smoke.py``'s scene (1920x1080,
shadow accuracy 10, synthetic int16/uint8 map of ``--synth-shape``) and
records the window extraction of one pose on each path: the march path's
three K1 launches (heights, albedo, shadow|bounce) and the blocked path's
K5 launches. Each launch is printed with its kernel's own device time
and the device time of whatever else its wrapper launches (a copy of a
strided level); then the copies the callers make around the kernels
(the albedo planes ``lvl[:, :, ch].contiguous()``, the ``torch.stack`` of
three albedo windows, the ``torch.cat`` of shadow and bounce windows),
each timed alone on tensors of the pose's shapes; then K1's sum per cold
frame and K5's per pose, the latter counting the stack and cat where the
checkout still makes them (six K5 launches a pose). ``--variants`` also
times K1 and K5 with each thread walking 2, 4 and 8 window rows
(``extract.ROWS_PER_THREAD``), where the checkout has that setting.

Every time is the mean over ``--reps`` replays of torch.profiler's device
events (no host time). ``--root`` names another checkout (say, the parent
commit unpacked with ``git archive``) whose ``moonrtx_tpu_torch`` is timed
instead, so two designs can be compared within one call on one card: run
it in turns (parent, change, change, parent). Prints one JSON object per
line, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, reps: int, kernel: str | None = None):
    """Mean milliseconds of the device kernels one call of fn launches
    (a window in which the profiler lost an event is measured again).
    With ``kernel``: (ms of the events whose name contains it, ms of all
    others)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if kernel is None:
            if evs and len(evs) % reps == 0:
                return sum(ev.time_range.elapsed_us() for ev in evs) \
                    / reps / 1e3
            continue
        mine = [ev.time_range.elapsed_us() for ev in evs
                if kernel in ev.name]
        rest = [ev.time_range.elapsed_us() for ev in evs
                if kernel not in ev.name]
        if len(mine) == reps and len(rest) % reps == 0:
            return sum(mine) / reps / 1e3, sum(rest) / reps / 1e3
    raise SystemExit(f"the profiler saw {len(evs)} device events in {reps} "
                     "calls")


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def scan_kernels(tag: str, reps: int) -> None:
    import torch

    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.ops import extract, shadow_prefix, shadow_scan

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
                           reps)
            emit(root=tag, kernel=name,
                 dtype=str(call["levels"][0].dtype),
                 blocks=call["wy"].shape[0], ms=ms)
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
                                   reps)
                    emit(root=tag, kernel=name, chunk_rows=rows,
                         grid=list(c["hs"].shape), ms=ms)


def _levels_text(levels) -> str:
    lv = levels[0]
    return f"{lv.dtype} {tuple(lv.shape)} strides {tuple(lv.stride())}"


def extract_kernels(tag: str, reps: int, synth_shape: str,
                    variants_too: bool) -> None:
    from datetime import datetime, timezone

    import torch

    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.engine import blocked
    from moonrtx_tpu_torch.ops import extract
    from moonrtx_tpu_torch.types import Observer

    os.environ["MOONRTX_TPU_CACHE"] = os.path.join(HERE, "chip_smoke_out",
                                                   "cache")
    th, tw = (int(v) for v in synth_shape.split("x"))
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=1920, height=1080, shadow_accuracy=10, backend="pallas",
        synth_shape=(th, tw), downscale=1).validate()
    scene = headless.build_scene(cfg)
    scene.update_view()
    with kernels.recording() as calls:
        scene.render(1)
    k1 = [c for n, c in calls if n == "extract_group_windows"]
    scene.backend = "blocked"
    scene.set_view_orientation(scene.view_orientation)  # drop pose caches
    with kernels.recording() as calls:
        scene.render(1)
    k5 = [c for n, c in calls if n == "extract_level_windows"]
    torch.cuda.synchronize()

    # the checkout's own setting first, then (with --variants, where the
    # checkout has the setting) each number of rows a thread walks
    variants = [{}]
    if variants_too and hasattr(extract, "ROWS_PER_THREAD"):
        variants += [dict(ROWS_PER_THREAD=n) for n in (2, 4, 8)]
    saved = {k: getattr(extract, k) for k in variants[-1]}
    for setting in variants:
        for key, value in {**saved, **setting}.items():
            setattr(extract, key, value)
        k1_sum = k5_sum = 0.0
        for call in k1:
            ms, other = device_ms(
                lambda: extract.extract_group_windows(**call), reps,
                "extract_group_kernel")
            out = extract.extract_group_windows(**call)
            k1_sum += ms + other
            emit(root=tag, kernel="extract_group_windows", **setting,
                 maps=len(call["map_levels"]),
                 levels=_levels_text(call["map_levels"][0]),
                 out=[str(out.dtype), list(out.shape)], ms=ms,
                 wrapper_other_ms=other)
        for call in k5:
            ms, other = device_ms(
                lambda: extract.extract_level_windows(**call), reps,
                "extract_level_kernel")
            out = extract.extract_level_windows(**call)
            k5_sum += ms + other
            levels = call["levels"]
            if not isinstance(levels[0], torch.Tensor):   # several maps
                levels = levels[0]
            emit(root=tag, kernel="extract_level_windows", **setting,
                 levels=_levels_text(levels), out=list(out.shape), ms=ms,
                 wrapper_other_ms=other)
        emit(root=tag, **setting, k1_kernels_ms=k1_sum, k5_kernels_ms=k5_sum)
        if not setting:
            own = k1_sum, k5_sum
    for key, value in saved.items():
        setattr(extract, key, value)
    k1_sum, k5_sum = own

    # the copies the callers make(-ed) around the kernels, on the pose's
    # shapes: albedo planes of K1's levels, stack of three albedo windows,
    # cat of shadow and bounce windows
    nblk = k5[0]["r0"].shape[0]
    alb = next(c for c in k1 if c["map_levels"][0][0].dtype == torch.uint8)
    alb_levels = ([lv for lv in alb["map_levels"][0]]
                  if alb["map_levels"][0][0].ndim == 3 else None)
    if alb_levels is None:   # planes of (H, W, 3) levels: their bases
        alb_levels = [torch.as_strided(
            lv, (lv.shape[0], lv.shape[1], 3), (lv.stride(0), 3, 1))
            for lv in alb["map_levels"][0]]
    planes = [lv[:, :, ch] for lv in alb_levels for ch in range(3)]
    copies = dict(
        albedo_plane_contiguous=lambda: [p.contiguous() for p in planes],
        stack_albedo_windows=lambda w=[torch.empty(
            (nblk, blocked.AWIN_H, blocked.AWIN_W), device="cuda")
            for _ in range(3)]: torch.stack(w, dim=-1),
        cat_shadow_bounce=lambda w=[torch.empty(
            (nblk, blocked.SWIN_H, blocked.SWIN_W), device="cuda")
            for _ in range(2)]: torch.cat(w, dim=2))
    copy_ms = {}
    for name, fn in copies.items():
        copy_ms[name] = device_ms(fn, reps)
        emit(root=tag, copy=name, ms=copy_ms[name],
             **({"planes": len(planes), "level_shapes": [
                 list(lv.shape) for lv in alb_levels]}
                if name.startswith("albedo") else {"blocks": nblk}))
    if len(k5) == 6:   # per-plane albedo launches, then stack and cat
        k5_sum += copy_ms["stack_albedo_windows"] \
            + copy_ms["cat_shadow_bounce"]
    emit(root=tag, k1_launches=len(k1), k1_ms_per_cold_frame=k1_sum,
         k5_launches=len(k5), k5_ms_per_pose_with_copies=k5_sum)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose moonrtx_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--what", default="all",
                    choices=("scan", "extract", "all"))
    ap.add_argument("--synth-shape", default="11520x23040")
    ap.add_argument("--variants", action="store_true",
                    help="extract: also time K1/K5 at 2, 4 and 8 rows "
                         "per thread")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    from moonrtx_tpu_torch import kernels

    tag = os.path.basename(root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit(root=tag, card=card)
    kernels.build_all()
    for src in kernels.SOURCES:
        regs = [ln.split(":", 1)[1].strip() for ln in
                kernels.build_log.get(src, "").splitlines()
                if "registers" in ln]
        emit(root=tag, source=src, ptxas=regs)
    if args.what in ("scan", "all"):
        scan_kernels(tag, args.reps)
    if args.what in ("extract", "all"):
        extract_kernels(tag, args.reps, args.synth_shape, args.variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
