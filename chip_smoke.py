#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moonrtx_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--synth-shape 11520x23040] [--out chip_smoke_out]

Drives the port's two main paths once each, the interactive session on
the first, the command line and the 4-device mesh, as a user would:
1920x1080,
shadow accuracy 10, indirect light, eclipse shading and earthshine on, on
a synthetic LOLA-sized map (int16 heights, uint8 albedo;
``--synth-shape 23040x46080`` is the full benchmark size): the march-kernel
path (``backend="pallas"``, a 32-sample burst) and the windowed "blocked"
path (what ``backend="auto"`` resolves to, 8 samples one at a time).
Phases, each fatal on failure:

1. the card (nvidia-smi name and power limit, torch device name);
2. build the CUDA kernels from csrc/ (parallel nvcc) and report it;
3. the march path: build_scene -> update_view -> render(32), with every
   kernel launch counter set to 0 just before and read just after; each
   of its kernels (K1-K4, the bounce kernels) must have launched, the
   march once and the burst kernel once, and the frame must be finite; then a warm re-burst (same pose) for the
   per-sample time.
   The blocked path, on the same scene and maps (switched with
   ``scene.backend``, pose caches dropped with ``set_view_orientation``):
   counters
   set to 0, render(8), counters read; K5 must have launched three times
   for the pose (heights, albedo as whole texels, shadow|bounce), the
   frame must be finite and agree with the march path's frame;
4. every kernel launch the two paths made is replayed on the same inputs:
   the kernel against its plain PyTorch version (with each kernel's
   tolerance), then timed: the kernel from torch.profiler's device events
   of its own launches (no host time; a kernel of several passes is the
   sum of its passes, which are also printed one by one; the bounce
   pyramid's wrapper launches its pyramid kernel once a bounce and its
   collapse kernel once a level and bounce), the plain
   version and, where one exists, a single library call computing the
   same function (or the stated half of it) from CUDA events;
   the bound is computed from these inputs (bytes at 3.35 TB/s, operations
   at 67 TFLOP/s float32, H100 SXM data sheet);
   then the prefix scan (K3), the window resample (K4) and the window
   extraction (K1, K5) run on inputs made with numpy from a seed that a
   wrong split of their work would get wrong
   (moonrtx_tpu_torch/hard_cases.py: tied keys across every chunk
   boundary, the maximum in row 0, rising and falling columns on three
   grids; windows on and past each level edge, every alignment of the
   first column, samples on the last row and column, three dtypes; for
   extraction also (H, W, 3) levels, levels smaller than the window, level
   indices out of range, 1 and 37 blocks and the shadow|bounce pair, five
   texel types, bit for bit), each against its plain version;
5. a small scene rendered through the kernels must agree with the same
   scene rendered by the plain versions on the CPU, for the march, the
   blocked and the gather reference backends; and a shadow scan whose
   resample group does not divide its block count (K5's other caller)
   must give the heights the CPU gives;
6. the interactive session on the phase-3 scene and maps, driven through
   app.session.Session on the march path: Q/W time steps that keep the
   pose windows or rebuild them, bounce-map rebuilds and refreshes queued
   behind the frame, the flip cache, the held-key speculation, W W W Q W
   Q Q W and Q Q W Q Q scrubs, 2-px orbit drags, picking and measurement; then time steps and drags on the
   blocked path. One ``# session:`` line per metric, named and measured
   as the reference's bench.py:191-350 (the key event up to the
   synchronised one-sample frame): time_step_latency_ms,
   time_step_rebuild_ms, time_step_held_mean_ms, time_step_prefetch_ms,
   time_step_miss_ms, time_step_mixed_mean_ms, time_step_backward_mean_ms,
   drag_step_ms, pick_ms, and the phase's peak device memory, with every
   kernel counter set to 0 before the phase and read after it. Checks:
   (a) a consumed speculation gives the frame and hit buffer of the same
   step rendered without one, bit for bit (a 1-, 15- and 360-minute step);
   (b) a flip-cache hit launches no kernel and shows the snapshot's frame;
   (c) the frames after held one-minute steps (with a bounce crossing
   whose next step reads the refreshed map) and after 2-px drags, each
   taken on until the next step would overrun the windows' drift budget,
   agree with the same view rendered from cold pose caches and a fresh
   bounce map, within phase 3b's bounds; (d) picks through the 128x128 window equal the full
   host hit buffer, and a centre pick and a measurement are finite;
7. the CLI on the card, once phase 3's scene is freed: ``python -m
   moonrtx_tpu_torch`` as a user types it, three times, on the same map
   and caches: a still frame (auto backend, so the blocked path, 8
   samples, two bounces, ``--devices 0``), a 4-frame time-lapse on the
   march path (32 samples, 15-minute steps) and the still frame with no
   card visible, and the still frame with ``--devices 4``. Checks: the
   first two exit 0 and name the card, every PNG is 1920x1080x3 uint8
   with the Moon on 20-90% of it, the time-lapse's first frame agrees
   with phase 3's frame within phase 3b's bounds (the flags give phase
   3's configuration), successive frames differ, the run without a card
   exits non-zero having saved nothing, and ``--devices 4`` on a host
   with fewer cards exits non-zero naming them (on four cards it
   renders). ``# cli:`` lines give each run's wall time and peak host
   RSS, and the intervals between the time-lapse's saves beside one time
   step and one PNG save timed alone;
8. the mesh (``moonrtx_tpu_torch.parallel``) on phase 3's configuration:
   4 logical devices on the one card (``make_mesh(4, virtual=True)``),
   or four cards where the host has them. 8a: a cold 32-sample frame
   through the strip programs and the phi-wedge scan, with exactly the
   launches the strips, wedges and groups imply (MESH_COLD_LAUNCHES), no
   single-device scan fallback, and the frame within phase 3b's bounds
   of phase 3's; 8b: four 15-minute Q/W steps through Session on the
   kept windows, a consumed speculation, a flip and a brightness reset
   (K2 alone), each frame within those bounds of the same view from cold
   caches; 8c: the render level band-sharded (a small
   ``hbm_budget_gb``, the camera at MESH_BAND_ZOOM of its distance so
   the render level is one the plan may band), its frame against the
   replicated frame of the same view; each kernel at the new shapes (K3
   and K4 on phi wedge 1, K2 on strip 0, K1 on device 1's band-local
   extraction) against its plain version. ``# mesh:`` lines give the
   cold frames and a kept-windows step in ms and the peak device memory
   of each part, labelled with the devices.

The second-to-last line of standard output is the card's name and power
limit, and the one before it the ``kernels`` JSON; the last line is the
``{"ok": true, "device": ...}`` JSON. Without a card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
SAMPLES = 32                   # accumulation samples of the march path
BLOCKED_SAMPLES = 8            # one-sample frames of the blocked path

# where each kernel lives, its __global__ functions (one per pass of a
# launch), and which TPU kernel it replaces
KERNELS = {
    "extract_group_windows": dict(
        source="moonrtx_tpu_torch/csrc/extract.cu",
        kernel=("extract_group_kernel",),
        replaces="moonrtx_tpu/ops/extract.py:372"),
    "extract_level_windows": dict(
        source="moonrtx_tpu_torch/csrc/extract.cu",
        kernel=("extract_level_kernel",),
        replaces="moonrtx_tpu/ops/extract.py:239"),
    "march_shade": dict(
        source="moonrtx_tpu_torch/csrc/march_shade.cu",
        kernel=("march_kernel",),
        replaces="moonrtx_tpu/ops/pallas_march.py:633"),
    # no pallas_call: the JAX package's burst is a jitted fori_loop
    "march_burst": dict(
        source="moonrtx_tpu_torch/csrc/march_shade.cu",
        kernel=("burst_kernel",),
        replaces="moonrtx_tpu/engine/blocked.py:940"),
    "shadow_factor": dict(
        source="moonrtx_tpu_torch/csrc/shadow_prefix.cu",
        kernel=("shadow_chunk_max_kernel", "shadow_factor_kernel"),
        replaces="moonrtx_tpu/ops/shadow_prefix.py:120"),
    "resample_group_windows": dict(
        source="moonrtx_tpu_torch/csrc/resample.cu",
        kernel=("resample_kernel",),
        replaces="moonrtx_tpu/ops/extract.py:516"),
    # no pallas_call: the JAX package's pyramid is jnp code XLA fuses
    "bounce_from_parts": dict(
        source="moonrtx_tpu_torch/csrc/bounce.cu",
        kernel=("bounce_pyramid_kernel", "bounce_collapse_kernel"),
        replaces="moonrtx_tpu/ops/shadow_scan.py:447"),
}
# the kernels each main path must launch
PATH_KERNELS = {
    "pallas": ("extract_group_windows", "march_shade", "march_burst",
               "shadow_factor", "resample_group_windows",
               "bounce_from_parts"),
    "blocked": ("extract_level_windows",),
    # the interactive session: time steps and drags on the march path (K1
    # shadow windows, K3/K4 scan, K4 and the bounce kernels in the bounce
    # refresh, K2), time steps on the blocked path (K5 shadow|bounce
    # windows)
    "session": ("extract_group_windows", "march_shade", "shadow_factor",
                "resample_group_windows", "extract_level_windows",
                "bounce_from_parts"),
}
SESSION_STEPS = 8          # steps per time-step metric (bench.py:191-350)
SESSION_PICKS = 20         # cursor positions of the pick metric
# phase 3b's bounds for a frame against the same frame rendered another way
FRAME_BOUNDS = "mean < 0.5, p99 <= 3, share < 0.005, hits >= 0.999"
K5_LAUNCHES_PER_POSE = 3   # heights, albedo (whole texels), shadow|bounce
# device ms of the earlier designs of the kernels redesigned since (one
# thread per column; a per-texel staging loop; a thread per texel and
# step), from PERF.md, on an NVIDIA H100 80GB HBM3 at 700.00 W: per launch
# from this script's phase 4, and K5's per pose (six launches, the stack
# and cat around them not counted) from tools/torch_kernel_tune.py
EARLIER_MS = {"shadow_factor": 0.7888, "resample_group_windows": 0.1700,
              "extract_group_windows": 0.2362,
              "extract_level_windows": 0.6027}
PER_POSE = ("extract_level_windows",)   # EARLIER_MS entries per pose


MESH_DEVICES = 4
# launches of one cold 32-sample frame on phase 3's configuration over the
# mesh, replicated (8a) or banded (8c): per phi wedge the scan's K4 twice
# (heights; the bounce map's albedo at half resolution) and K3 once; K1
# three times per strip (heights, albedo, shadow|bounce; banded, the first
# two are each device's band-local extraction for the whole frame); K2
# once per sample and strip (the strips' own burst loop, no burst
# kernel); no K5; the bounce pyramid once, on the gathered grid
MESH_COLD_LAUNCHES = {"resample_group_windows": 2 * MESH_DEVICES,
                      "shadow_factor": MESH_DEVICES,
                      "extract_group_windows": 3 * MESH_DEVICES,
                      "march_shade": SAMPLES * MESH_DEVICES,
                      "march_burst": 0, "extract_level_windows": 0,
                      "bounce_from_parts": 1}
MESH_BAND_BUDGET_GB = 0.01     # 8c: small enough to band the render level
# 8c's camera, at this share of phase 3's distance: the render level is
# then the 5760-row level 1 of the 11520-row map, which the band plan may
# band, with the shadow scan on level 2 (at phase 3's view the render
# level, 1440 rows, is also the scan's level, which stays replicated by
# design: engine/scene.py _plan_bands)
MESH_BAND_ZOOM = 0.35


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs (after a warm-up),
    from CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, passes: tuple, reps: int,
              per_call: dict | None = None) -> tuple[float, dict]:
    """Mean device milliseconds of one call of fn, which launches each of
    the CUDA functions ``passes`` once (or ``per_call[pass]`` times), over
    reps calls (after a warm-up): (all passes summed, {pass: its own}).
    From torch.profiler's device events of those functions alone, so the
    host work of the wrapper between launches is not counted. Every pass
    should show exactly its launches, but the profiler sometimes drops a
    few (29 of 30, once 10 of 30): such a window is measured again, up to
    five in all, and after that the last one counts if it shows at least
    half of every pass's launches, each pass averaged over the events it
    has."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = {kernel: [ev.time_range.elapsed_us() for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and kernel in ev.name] for kernel in passes}
        seen = {kernel: len(v) for kernel, v in us.items()}
        want = {kernel: reps * (per_call or {}).get(kernel, 1)
                for kernel in passes}
        if seen == want:
            break
        print(f"#   profiler window {attempt}: saw {seen} launches, expected "
              f"{want}", flush=True)
    if not all(want[k] // 2 <= n <= want[k] for k, n in seen.items()):
        fail(f"the profiler saw {seen} launches, expected {want}")
    by_pass = {kernel: sum(v) / len(v) / 1e3 * want[kernel] / reps
               for kernel, v in us.items()}
    return sum(by_pass.values()), by_pass


def touched_bytes(levels, lvl_idx, r0, c0, wh: int, ww: int) -> int:
    """Bytes of the distinct texels that per-block (wh, ww) windows cut
    from their levels (a texel read by several windows counts once, with
    all its channels). ``levels`` is one pyramid or several (maps)."""
    import torch

    if not isinstance(levels[0], torch.Tensor):
        return sum(touched_bytes(m, lvl_idx, r0, c0, wh, ww)
                   for m in levels)
    lvl_idx = torch.clamp(lvl_idx, 0, len(levels) - 1)
    total = 0
    for k, lvl in enumerate(levels):
        sel = lvl_idx == k
        if not bool(sel.any()):
            continue
        h, w = lvl.shape[0], lvl.shape[1]
        rr = torch.clamp(r0[sel].long(), 0, h - 1)
        cc = torch.clamp(c0[sel].long(), 0, w - 1)
        diff = torch.zeros((h + 1, w + 1), dtype=torch.int32,
                           device=lvl.device)
        ones = torch.ones_like(rr, dtype=torch.int32)
        r1 = torch.clamp(rr + wh, max=h)
        c1 = torch.clamp(cc + ww, max=w)
        for ri, ci, sign in ((rr, cc, 1), (rr, c1, -1), (r1, cc, -1),
                             (r1, c1, 1)):
            diff.index_put_((ri, ci), sign * ones, accumulate=True)
        cover = diff.cumsum(0).cumsum(1)[:h, :w] > 0
        total += int(cover.sum()) * lvl.element_size() * (
            lvl.shape[2] if lvl.ndim == 3 else 1)
    return total


def frame_diff(img_a, img_b, hit_a, hit_b) -> dict:
    """Per-pixel max |d| statistics of two uint8 frames and the hit-flag
    agreement."""
    import numpy as np

    d = np.abs(img_a.astype(int) - img_b.astype(int)).max(axis=-1)
    return dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                over8=float((d > 8).mean()),
                hits=float((hit_a == hit_b).mean()))


def within_frame_bounds(st: dict) -> bool:
    return (st["mean"] < 0.5 and st["p99"] <= 3 and st["over8"] < 0.005
            and st["hits"] >= 0.999)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def launches_per_call(name: str, call: dict) -> dict | None:
    """Launches of each pass in one call of a wrapper that launches a pass
    more than once: the bounce pyramid's kernel once a bounce, its
    collapse kernel once a level and bounce."""
    if name != "bounce_from_parts":
        return None
    from moonrtx_tpu_torch.ops import shadow_scan

    passes = 2 if call["n_bounces"] >= 2 else 1
    return {"bounce_pyramid_kernel": passes,
            "bounce_collapse_kernel": passes * shadow_scan.bounce_levels(
                *call["hs"].shape)}


def bound_of(name: str, call: dict, out) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for one launch on
    these inputs: each input byte read once, each output byte written
    once; operations at the float32 peak."""
    if name == "extract_group_windows":
        by = touched_bytes(call["map_levels"], call["lvl_idx"], call["r0"],
                           call["c0"], call["wh"], call["ww"])
        by += nbytes(call["lvl_idx"], call["r0"], call["c0"], out)
        ops = 2 * out.numel()                       # decode multiply + add
    elif name == "extract_level_windows":
        by = touched_bytes(call["levels"], call["lvl_idx"], call["r0"],
                           call["c0"], call["wh"], call["ww"])
        by += nbytes(call["lvl_idx"], call["r0"], call["c0"], out)
        ops = 2 * out.numel()                       # decode multiply + add
    elif name == "resample_group_windows":
        by = touched_bytes(call["levels"], call["lvl_idx"], call["r0"],
                           call["c0"], call["wh"], call["ww"])
        by += nbytes(call["lvl_idx"], call["r0"], call["c0"], call["wy"],
                     call["wx"], out)
        nblk = call["wy"].shape[0]
        # decode + mean + residual per window texel, ~20 per sample
        ops = 4 * nblk * call["wh"] * call["ww"] + 20 * call["wy"].numel()
    elif name == "shadow_factor":
        by = nbytes(call["hs"], call["st"], call["ct"], out)
        ops = 40 * call["hs"].numel()               # scan step + atan2
    elif name == "bounce_from_parts":
        # portbench/metrics/bounce.roofline.view.py's count: hs, factor,
        # alb_s and the map once, each coarser level's inputs once, the
        # plain version's operations a cell of each level and bounce
        by, ops = bounce_count(call)
    elif name == "march_burst":
        # rays known live from sample 0's hits: K2's 360 flops a ray and
        # 400 a hit for each warm sample; params, chord bounds, jitters,
        # sample 0's planes and the mean once; the windows of the strips
        # with a hit in sample 0 once
        hit = call["f_prev"] > 0.5
        ns = hit.shape[0]
        n_hit = int(hit.reshape(ns, -1).amax(dim=1).sum())
        by = nbytes(call["params"], call["jitters"][:call["n_samples"]],
                    call["r"], call["g"], call["b"], call["t_prev"],
                    call["f_prev"], *out)
        if call["h_bound"] is not None:
            by += nbytes(call["h_bound"])
        by += nbytes(call["scal"], call["hwin"], call["awin"],
                     call["swin"]) * n_hit // ns
        ops = (call["n_samples"] - 1) * 760 * int(hit.sum())
    else:  # march_shade
        act = call["active"].reshape(call["active"].shape[0], -1)
        live = act.amax(dim=1) > 0.5                # strips with a live ray
        hit = out[3].reshape(out[3].shape[0], -1).amax(dim=1) > 0.5
        n_live, n_hit = int(live.sum()), int(hit.sum())
        ns = act.shape[0]
        rays = [call[k] for k in ("dbx", "dby", "dbz", "t_enter", "t_end",
                                  "active")]
        if call["t_prev"] is not None:
            rays += [call["t_prev"], call["f_prev"]]
        by = nbytes(call["params"], *rays, *out)
        by += (nbytes(call["scal"]) + nbytes(call["hwin"])) * n_live // ns
        by += (nbytes(call["awin"]) + nbytes(call["swin"])) * n_hit // ns
        # >= 6 field evaluations per ray (warm bracket + refinement), ~60
        # flops each, plus ~400 flops of normal and shading per hit ray
        ops = 360 * act.numel() + 400 * int((out[3] > 0.5).sum())
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounce_count(call: dict) -> tuple[int, int]:
    """(bytes, float32 operations) of the bounce pyramid's least time
    (portbench/metrics/bounce.roofline.view.py holds the same count)."""
    from moonrtx_tpu_torch.ops import shadow_scan

    n_theta, n_phi = call["hs"].shape
    passes = 2 if call["n_bounces"] >= 2 else 1
    cells = [(n_theta >> k) * (n_phi >> k) for k in
             range(shadow_scan.bounce_levels(n_theta, n_phi))]
    n0 = cells[0]
    by = 4 * n0 * 4 + 4 * sum(cells[1:]) * (2 + passes)
    # a cell of a level: 8 sectors of 15, blur and h_blk 12; the collapse
    # 104 where a coarser level exists; decimation 11 on coarser levels;
    # level 0's sum 18, its n.l 20, the second bounce's product and sum 2
    per_bounce = (sum(cells) * 132 + sum(cells[:-1]) * 104
                  + sum(cells[1:]) * 11 + n0 * 18)
    return by, passes * per_bounce + n0 * 20 + (passes - 1) * n0 * 2


def library_call(name: str, call: dict):
    """One PyTorch call computing the kernel's function on the same
    inputs, or None. K3: torch.cummax over the keys m (its scan half
    only: the carried z, the shift to the exclusive scan and the factor
    are left out; m is formed outside the timed call). K4: F.grid_sample
    over the decoded windows (its bilinear half only; the windows are cut
    outside the timed call). K1 and K5, for a launch of one map with a
    single level: one advanced-indexing gather of the raw windows (the
    decode left out; K1's group layout is the gather's own); a launch
    that picks among several levels has no single call."""
    import torch
    import torch.nn.functional as F

    from moonrtx_tpu_torch.ops import extract

    one_level = None
    if name == "extract_level_windows" and isinstance(
            call["levels"][0], torch.Tensor) and len(call["levels"]) == 1:
        one_level = call["levels"][0]
    if name == "extract_group_windows" and len(call["map_levels"]) == 1 \
            and len(call["map_levels"][0]) == 1:
        one_level = call["map_levels"][0][0]
    if one_level is not None:
        lvl = one_level
        rows = (call["r0"].long()[:, None]
                + torch.arange(call["wh"], device=lvl.device))[:, :, None]
        cols = (call["c0"].long()[:, None]
                + torch.arange(call["ww"], device=lvl.device))[:, None, :]
        return lambda: lvl[rows, cols]
    if name == "shadow_factor":
        m = call["moon_radius"] * call["hs"] * call["st"]
        return lambda: torch.cummax(m, dim=0)
    if name != "resample_group_windows":
        return None
    win = extract.decode_affine(
        extract._cut_windows(call["levels"], call["lvl_idx"], call["r0"],
                             call["c0"], call["wh"], call["ww"]),
        call["scale"], call["offset"])[:, None]
    wy = torch.clamp(call["wy"], 0.0, call["wh"] - 1.001)
    wx = torch.clamp(call["wx"], 0.0, call["ww"] - 1.001)
    grid = torch.stack([2.0 * wx / (call["ww"] - 1) - 1.0,
                        2.0 * wy / (call["wh"] - 1) - 1.0], dim=-1)[:, None]
    return lambda: F.grid_sample(win, grid, mode="bilinear",
                                 align_corners=True)


def compare(name: str, call: dict, got, ref) -> list:
    """[(output, max abs error, tolerance), ...] of a kernel against its
    plain version, the main output first; fails if an error exceeds its
    tolerance."""
    if name in ("extract_group_windows", "extract_level_windows"):
        import torch

        err = float((got.float() - ref.float()).abs().max())
        tol = 0.0                                   # bit-exact
        bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
        if not torch.equal(got.view(bits), ref.view(bits)):
            fail(f"{name}: not bit-equal to its plain version (the sign "
                 "of a zero, or a NaN's bits)")
    elif name == "resample_group_windows":
        # bf16 residual budget: the window mean is summed in another
        # order, which can move one bf16 rounding of a residual
        from moonrtx_tpu_torch.ops import extract

        win = extract.decode_affine(extract._cut_windows(
            call["levels"], call["lvl_idx"], call["r0"], call["c0"],
            call["wh"], call["ww"]), call["scale"], call["offset"])
        spread = win.amax(dim=(1, 2)) - win.amin(dim=(1, 2))
        err = float((got - ref).abs().max())
        tol = 4e-3 * float(spread.max())
    elif name == "shadow_factor":
        err = float((got - ref).abs().max())
        tol = 1e-4                                  # atan2 polynomial
    elif name == "bounce_from_parts":
        # 1e-5, except on no larger a share of cells than that which 1-ulp
        # noise on hs moves the plain version itself beyond 1e-5: there
        # what the noise moves it (a tie of two sin^2 flips a choice;
        # tests/test_torch_gpu.py BOUNCE_TOL)
        import numpy as np
        import torch

        from moonrtx_tpu_torch.ops import shadow_scan

        hs = call["hs"].cpu().numpy()
        up = np.random.default_rng(11).random(hs.shape) < 0.5
        noisy_hs = np.nextafter(hs, np.where(up, np.inf, -np.inf)
                                .astype(np.float32))
        noisy = shadow_scan.bounce_from_parts_plain(**dict(
            call, hs=torch.from_numpy(noisy_hs).to(call["hs"].device)))
        d, moved = (got - ref).abs(), (noisy - ref).abs()
        err = float(d.max())
        tol = max(1e-5, float(moved.max()))
        share = float((d > 1e-5).float().mean())
        noise_share = float((moved > 1e-5).float().mean())
        if share > noise_share:
            fail(f"{name}: {share:.3g} of cells beyond 1e-5, more than the "
                 f"{noise_share:.3g} that 1-ulp noise on hs moves")
    elif name == "march_burst":
        # the mean of K2's samples, whose rgb is within 2.6e-5 of its plain
        # version's on this map (PERF.md)
        err = max(float((got[i] - ref[i]).abs().max()) for i in range(3))
        tol = 1e-4
    else:
        hit_agree = float((got[3] == ref[3]).float().mean())
        if hit_agree < 0.999:
            fail(f"{name}: hit flags agree on {hit_agree:.5f} < 0.999")
        both = (got[3] > 0.5) & (ref[3] > 0.5)
        checks = [("rgb", max(float((got[i] - ref[i]).abs().max())
                              for i in range(3)), 2e-2)]
        # the hit distance seeds the next sample's warm bracket; the hit
        # point follows from it (tests/test_torch_march.py's bound)
        for i, what in ((4, "t_hit"), (5, "px"), (6, "py"), (7, "pz")):
            err = float((got[i] - ref[i]).abs()[both].max()) \
                if bool(both.any()) else 0.0
            checks.append((what, err, 5e-2))
        for what, err, tol in checks:
            if not err <= tol:
                fail(f"{name}: {what} max error {err} > tolerance {tol}")
        return checks
    if not err <= tol:
        fail(f"{name}: max error {err} > tolerance {tol}")
    return [("out", err, tol)]


def session_phase(scene) -> None:
    """Phase 6: the interactive session on the phase-3 scene and maps,
    driven through app.session.Session. Prints one ``# session:`` line per
    metric (named and measured as the reference's bench.py:191-350: the
    timed span is the key event up to the synchronised one-sample frame;
    the speculation and display that follow are untimed) and fails on any
    check (a)-(d) and if a kernel of the session was never launched."""
    from datetime import timedelta

    import numpy as np
    import torch

    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.app.session import Session
    from moonrtx_tpu_torch.astro import calculate_ephemeris
    from moonrtx_tpu_torch.data.features import load_moon_features
    from moonrtx_tpu_torch.engine.scene import _rotation_angle_deg
    from moonrtx_tpu_torch.interact import navigation as nav

    step15 = timedelta(minutes=15)

    def sync():
        torch.cuda.synchronize()

    def hits_of():
        return (scene._hitbuf[..., 3] > 0).cpu().numpy()[
            :scene.out_height, :scene.out_width]

    def say(text):
        print(f"# session: {text}", flush=True)

    def timed(event):
        """ms of event() + the one-sample frame, synchronised; and whether
        the pose windows survived."""
        org = scene._origins
        t0 = time.perf_counter()
        event()
        scene.ensure_accumulated(1)
        sync()
        return (time.perf_counter() - t0) * 1e3, scene._origins is org

    def cold_frame():
        """The current datetime and camera from cold pose caches and a
        fresh bounce map (no flip cache, no speculation)."""
        scene._prefetch = None
        scene._flip_cache = None
        scene._bounce = scene._bounce_basis = scene._bounce_key = None
        scene._shadow_dirty = True
        scene.set_view_orientation(scene.view_orientation)
        img = scene.render(1)
        return img, hits_of()

    def check_against_cold(what, img, hit):
        used = scene._window_drift
        img_c, hit_c = cold_frame()
        st = frame_diff(img, img_c, hit, hit_c)
        say(f"(c) the frame after the {what} (windows drifted {used:.4f} of "
            f"their {budget:.4f} deg) against the same view from "
            f"cold pose caches and a fresh bounce map: mean |d| "
            f"{st['mean']:.4f}, p99 |d| {st['p99']:.1f}, share beyond 8 "
            f"levels {st['over8']:.5f}, hit agreement {st['hits']:.5f} "
            f"(tolerance: {FRAME_BOUNDS})")
        if not within_frame_bounds(st):
            fail(f"session: the frame after the {what} disagrees with the "
                 "cold render")

    scene.backend = "pallas"
    scene.set_view_orientation(scene.view_orientation)  # march windows
    scene._prefetch = None
    scene._flip_cache = None
    sync()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sess = Session(scene, load_moon_features(None))
    sess.frame()                            # the pose at the start time
    level = scene.mip_level()
    rows = scene.mip_shapes[level][0]
    budget = 4.0 * 180.0 / rows
    say(f"render level {level} ({rows} rows): the windows' drift budget is "
        f"{budget:.4f} deg of rotation or camera sweep")

    def rotation(dt):
        return np.asarray(calculate_ephemeris(
            dt, scene.config.observer, scene.parallactic_mode).rotation_matrix)

    def scene_step(minutes=15):
        """(ms, windows kept, the step's rotation drift in deg)."""
        prev = np.asarray(scene.ephem.rotation_matrix)
        ms, kept = timed(lambda: scene.update_view(
            scene.dt_local + timedelta(minutes=minutes)))
        return ms, kept, _rotation_angle_deg(
            np.asarray(scene.ephem.rotation_matrix), prev)

    def drifts(runs):
        return (f"rotation per step {[round(d, 4) for *_, d in runs]} deg "
                f"against the {budget:.4f} deg budget")

    # warm both step paths (drift reuse, bounce rebuild)
    scene_step()
    scene._bounce_basis = None
    scene_step()
    steps = [scene_step() for _ in range(SESSION_STEPS)]
    say(f"time_step_latency_ms {min(ms for ms, *_ in steps):.3f} (min of "
        f"{SESSION_STEPS}; all {[round(ms, 2) for ms, *_ in steps]}; pose "
        f"windows kept on {sum(k for _, k, _ in steps)} of {SESSION_STEPS}; "
        f"{drifts(steps)})")

    rebuilds = []
    for _ in range(3):
        scene._bounce_basis = None          # trip the drift threshold
        rebuilds.append(scene_step()[0])
    say(f"time_step_rebuild_ms {sorted(rebuilds)[1]:.3f} (median of 3: "
        f"{[round(ms, 2) for ms in rebuilds]})")

    # held key: crossings of the bounce threshold refresh the map behind
    # the frame; warm that variant with a forced crossing first
    a = np.deg2rad(0.8)
    rot = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                    [0, np.sin(a), np.cos(a)]], np.float64)
    scene._bounce_basis = (rot @ scene._bounce_basis.T).T
    scene_step()
    held, display_ms, refreshed, rebuilt = [], [], 0, 0
    for _ in range(SESSION_STEPS):
        bounce = scene._bounce
        held.append(scene_step())
        if scene._bounce is not bounce:
            # a kept pose runs the merged step, which refreshes the bounce
            # map behind the frame; a pose rebuild rebuilds it before
            refreshed += held[-1][1]
            rebuilt += not held[-1][1]
        t0 = time.perf_counter()
        scene.display()
        display_ms.append((time.perf_counter() - t0) * 1e3)
    held_ms = float(np.mean([ms for ms, *_ in held]))
    say(f"time_step_held_mean_ms {held_ms:.3f} "
        f"(mean of {SESSION_STEPS}; {[round(ms, 2) for ms, *_ in held]}; "
        f"pose windows kept on {sum(k for _, k, _ in held)}; bounce map "
        f"refreshed behind the frame {refreshed}, rebuilt with a pose "
        f"{rebuilt} times; the display copy after each step "
        f"{np.mean(display_ms):.3f} ms; {drifts(held)})")

    # a threshold crossing on a kept pose: one-minute steps keep the
    # windows; a bounce basis turned 0.6 deg (past BOUNCE_REUSE_DEG, inside
    # BOUNCE_ASYNC_MAX_DEG) makes the next step refresh the map behind its
    # frame, and the step after it must read the refreshed map
    from moonrtx_tpu_torch.engine import blocked

    read = []
    real = blocked.render_timestep_scan_pallas

    def spy(*args, **kw):
        read.append(args[1])            # the bounce map the step shades with
        return real(*args, **kw)

    scene.set_view_orientation(scene.view_orientation)  # fresh windows
    scene_step(1)
    a = np.deg2rad(0.6)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float64)
    scene._bounce_basis = (rot @ scene._bounce_basis.T).T
    blocked.render_timestep_scan_pallas = spy
    try:
        old_map = scene._bounce
        _, kept1, _ = scene_step(1)
        new_map = scene._bounce
        _, kept2, _ = scene_step(1)
    finally:
        blocked.render_timestep_scan_pallas = real
    ok = (kept1 and kept2 and len(read) == 2 and read[0] is old_map
          and new_map is not old_map and read[1] is new_map)
    say(f"bounce threshold crossing on a kept pose: the crossing step shaded "
        f"with the cached map and queued a refresh "
        f"({bool(read) and read[0] is old_map and new_map is not old_map}), "
        f"the next step read the refreshed map ({ok}); windows kept "
        f"{kept1}, {kept2}; merged steps {len(read)}")
    if not ok:
        fail("session: the step after a bounce crossing did not read the "
             "refreshed map")
    # held one-minute steps on the same windows and bounce map until the
    # next step would overrun the windows' drift budget
    edge = 0
    while edge < 240 and scene._windows_hold(_rotation_angle_deg(
            rotation(scene.dt_local + timedelta(minutes=1)),
            np.asarray(scene.ephem.rotation_matrix))):
        if not scene_step(1)[1]:
            fail("session: a step inside the drift budget rebuilt the "
                 "windows")
        edge += 1
    img_h = scene.display()
    check_against_cold(f"crossing and {edge + 1} more held one-minute "
                       "steps", img_h, hits_of())

    # speculative held key, through Session.change_time + Session.frame
    sess.change_time(15)
    sess.frame()
    pf_ms, pf_hits, pf_kinds, frame_ms = [], 0, [], []
    for _ in range(SESSION_STEPS):
        pf = scene._prefetch
        ms, _ = timed(lambda: sess.change_time(15))
        pf_hits += pf is not None and scene._accum is pf["accum"]
        pf_kinds.append(None if pf is None else pf["kind"])
        pf_ms.append(ms)
        t0 = time.perf_counter()
        sess.frame()                        # speculation + display copy
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    say(f"time_step_prefetch_ms {np.mean(pf_ms):.3f} (mean of "
        f"{SESSION_STEPS}; {[round(ms, 2) for ms in pf_ms]}; prefetch hits "
        f"{pf_hits} of {SESSION_STEPS}; kinds {pf_kinds}; Session.frame's "
        f"speculation dispatch + display copy after each step "
        f"{np.mean(frame_ms):.3f} ms)")
    say(f"key-to-frame of a held key (step + the display copy or "
        f"Session.frame): unspeculated {held_ms + np.mean(display_ms):.3f} "
        f"ms; speculated {np.mean(pf_ms) + np.mean(frame_ms):.3f} ms")

    def scrub(keys):
        """Key presses through Session; a step is covered by the flip cache
        or by a speculation that survived its update_view (bench.py)."""
        times, hits, misses = [], 0, []
        for key in keys:
            t0 = time.perf_counter()
            sess.handle_key(key)
            hit = scene._prefetch is not None or scene.last_flip_hit
            scene.ensure_accumulated(1)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            times.append(ms)
            hits += hit
            if not hit:
                misses.append(ms)
            sess.frame()
        return times, hits, misses

    mixed, mixed_hits, miss = scrub("wwwqwqqw")
    say(f"time_step_miss_ms {max(miss) if miss else None} (worst uncovered "
        f"step of W W W Q W Q Q W)")
    say(f"time_step_mixed_mean_ms {np.mean(mixed):.3f} "
        f"({[round(ms, 2) for ms in mixed]}; covered by the flip cache or a "
        f"speculation: {mixed_hits} of 8)")
    back, back_hits, _ = scrub("qqwqq")
    say(f"time_step_backward_mean_ms {np.mean(back):.3f} "
        f"({[round(ms, 2) for ms in back]}; covered {back_hits} of 5)")

    # (b) a flip hit launches nothing and shows the snapshot's frame
    scene._prefetch = None
    img_t = scene.display()
    sess.handle_key("w")
    sess.frame()
    sync()
    with kernels.recording() as calls:
        sess.handle_key("q")
        flip = scene.last_flip_hit
        scene.ensure_accumulated(1)
    img_q = scene.display()
    say(f"(b) flip back: flip-cache hit {flip}, kernel launches {len(calls)}"
        f", frame equal to the snapshot's: {np.array_equal(img_q, img_t)}")
    if not flip or calls or not np.array_equal(img_q, img_t):
        fail("session: the flip step launched kernels or changed the frame")

    # (a) a consumed speculation against the same step without one, from
    # the same state: the flip back to t restores that state
    kinds = set()
    for minutes in (1, 15, 360):
        sess.frame()
        scene._prefetch = None
        scene._flip_cache = None
        t = scene.dt_local
        if not scene.prefetch_time(t + timedelta(minutes=minutes)):
            fail("session: prefetch_time dispatched nothing")
        pf = scene._prefetch
        scene.update_view(t + timedelta(minutes=minutes))
        scene.ensure_accumulated(1)
        consumed = scene._accum is pf["accum"]
        img_a, hit_a = scene.display(), scene._hitbuf
        scene.update_view(t)
        if not scene.last_flip_hit:
            fail("session: the flip back to the speculation's state missed")
        scene._flip_cache = None
        scene.update_view(t + timedelta(minutes=minutes))
        scene.ensure_accumulated(1)
        img_b = scene.display()
        same = np.array_equal(img_a, img_b) and torch.equal(hit_a,
                                                            scene._hitbuf)
        d = int(np.abs(img_a.astype(int) - img_b.astype(int)).max())
        say(f"(a) {minutes}-minute step, {pf['kind']} speculation consumed "
            f"{consumed}: frame against the unspeculated step max |d| {d}, "
            f"hit buffers equal {same}")
        if not consumed or not same:
            fail("session: a consumed speculation differs from the step "
                 "rendered without it")
        kinds.add(pf["kind"])
    if kinds != {"timestep", "pose"}:
        fail(f"session: check (a) saw speculations of kinds {kinds} only")

    # drags: 2-px orbit steps that keep the windows
    sess.frame()
    drags = [timed(lambda: sess.orbit_drag(2.0, 0.0))
             for _ in range(SESSION_STEPS)]
    say(f"drag_step_ms {np.mean([ms for ms, _ in drags]):.3f} (mean of "
        f"{SESSION_STEPS} 2-px orbit drags; "
        f"{[round(ms, 2) for ms, _ in drags]}; windows kept on "
        f"{sum(k for _, k in drags)} of {SESSION_STEPS}, drifted "
        f"{scene._window_drift:.4f} of {budget:.4f} deg)")
    if sum(k for _, k in drags) == 0:
        fail("session: no drag step kept the pose windows")
    # more drags on the same windows until the next would overrun the budget
    edge = 0
    while edge < 2000:
        cam = nav.orbit_drag(scene.camera, 2.0, 0.0, scene.out_height)
        d = scene._camera_drift_deg(scene.camera, cam)
        if d is None or not scene._windows_hold(d):
            break
        org = scene._origins
        sess.orbit_drag(2.0, 0.0)
        if scene._origins is not org:
            fail("session: a drag inside the drift budget rebuilt the "
                 "windows")
        edge += 1
    scene.ensure_accumulated(1)
    img_d = scene.display()
    check_against_cold(f"{SESSION_STEPS + edge} drag steps", img_d,
                       hits_of())

    # (d) picking on a fresh frame, then measurement
    sess.frame()
    cy, cx = scene.out_height // 2, scene.out_width // 2
    # a cursor sweeping across the disc, 20 px an event: the pick window
    # re-centres every few positions
    pts = [(min(int(cx - 0.2 * cx + 20 * k), scene.out_width - 1),
            min(int(cy - 0.1 * cy + 6 * k), scene.out_height - 1))
           for k in range(SESSION_PICKS)]
    copies, win = 0, None
    t0 = time.perf_counter()
    vals = []
    for x, y in pts:
        vals.append(scene.get_hit_at(x, y))
        copies += scene._pickwin is not win
        win = scene._pickwin
    pick_ms = (time.perf_counter() - t0) * 1e3 / len(pts)
    buf = scene.hit_buffer_host()
    equal = all(v == tuple(float(c) for c in buf[y, x])
                for v, (x, y) in zip(vals, pts))
    lat, lon = sess.pick(cx, cy)
    sess.start_measurement(cx - cx // 6, cy - cy // 8)
    sess.finish_measurement(cx + cx // 6, cy + cy // 6)
    dist, dh = sess.measured_distance, sess.measured_height_diff
    say(f"pick_ms {pick_ms:.4f} (mean of {len(pts)} cursor positions, "
        f"{copies} window copies of {scene.PICK_WIN}x{scene.PICK_WIN}x4); "
        f"(d) equal to the full host buffer {equal}; centre pick lat "
        f"{lat}, lon {lon}; measured {dist} km, dh {dh} m")
    if not (equal and lat is not None and np.isfinite([lat, lon]).all()
            and dist is not None and np.isfinite([dist, dh]).all()):
        fail("session: picking or measurement is wrong")
    peak_pallas = torch.cuda.max_memory_allocated() / 2**30

    # the blocked path (phase 3b's scene): time steps and drags
    scene.backend = "blocked"
    scene.set_view_orientation(scene.view_orientation)
    scene._prefetch = None
    scene._flip_cache = None
    sess.frame()
    b_steps = [timed(lambda: sess.change_time(15)) for _ in range(4)]
    b_drags = [timed(lambda: sess.orbit_drag(2.0, 0.0)) for _ in range(4)]
    sync()
    for what, runs in (("time steps", b_steps), ("drag steps", b_drags)):
        say(f"blocked path, 4 {what}: {[round(ms, 2) for ms, _ in runs]} ms, "
            f"pose windows kept on {sum(k for _, k in runs)} of 4")
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"peak device memory {peak:.2f} GiB (march path part "
        f"{peak_pallas:.2f}); launches {counts}")
    for name in PATH_KERNELS["session"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched in the session")


def mesh_phase(cfg, img3, hit3, card: str, out_dir: str) -> None:
    """Phase 8: the mesh on the card, on phase 3's configuration: 4
    logical devices on cuda:0 when the host has fewer than four cards,
    four cards otherwise. 8a a cold frame through the strip programs
    against phase 3's frame, with the launch counts MESH_COLD_LAUNCHES;
    8b the interactive session (four 15-minute Q/W steps on the kept
    windows, a consumed speculation, a flip, a brightness reset), each
    frame against the same view from cold caches; 8c the same scene with
    the render level band-sharded against 8a's frame; each kernel at the
    new shapes (K3/K4 on wedge 1, K2 on one strip, K1 on one device's
    band-local extraction) against its plain version. Fails on any
    check; times and peak memory are recorded, not bounded."""
    import dataclasses

    import numpy as np
    import torch

    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.app.session import Session
    from moonrtx_tpu_torch.data.features import load_moon_features
    from moonrtx_tpu_torch.engine import scene as scene_mod
    from moonrtx_tpu_torch.ops import extract, march_shade, shadow_prefix
    from moonrtx_tpu_torch.parallel import make_mesh

    def say(msg: str) -> None:
        print(f"# mesh: {msg}", flush=True)

    n_cards = torch.cuda.device_count()
    mesh = make_mesh(MESH_DEVICES, virtual=n_cards < MESH_DEVICES)
    where = (f"{MESH_DEVICES} logical devices on one {card}" if mesh.virtual
             else f"{MESH_DEVICES} cards ({card} each)")
    say(f"mesh of {where}: {[str(d) for d in mesh.devices]}")
    events = []
    real_log = scene_mod.log_event

    def logged(name, **kw):
        events.append(name)
        real_log(name, **kw)

    scene_mod.log_event = logged
    plain = {"extract_group_windows": extract.extract_group_windows_plain,
             "resample_group_windows": extract.resample_group_windows_plain,
             "shadow_factor": shadow_prefix.shadow_factor_plain,
             "march_shade": march_shade.march_shade_plain}
    wrapper = kernels.wrappers()

    def hold(what: str, name: str, call: dict) -> None:
        got = wrapper[name](**call)
        ref = plain[name](**call)
        torch.cuda.synchronize()
        checks = compare(name, call, got, ref)
        ms, _ = device_ms(lambda: wrapper[name](**call),
                          KERNELS[name]["kernel"], 30)
        say(f"{name} at {what}: " + ", ".join(
            f"{w} max |err| {e:.3g} (tolerance {t:.3g})"
            for w, e, t in checks) + f"; {ms:.4f} ms a launch (device, "
            f"{where})")

    def hits_of(sc):
        return (sc._hitbuf[..., 3] > 0).cpu().numpy()[
            :sc.out_height, :sc.out_width]

    def against(what: str, img, hit, img_b, hit_b) -> None:
        st = frame_diff(img, img_b, hit, hit_b)
        say(f"{what}: mean |d| {st['mean']:.4f}, p99 |d| {st['p99']:.1f}, "
            f"share beyond 8 levels {st['over8']:.5f}, hit agreement "
            f"{st['hits']:.5f} (tolerance: {FRAME_BOUNDS})")
        if not within_frame_bounds(st):
            fail(f"mesh: {what} is out of bounds")

    def cold_burst(sc, label: str):
        sc.update_view()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with kernels.recording() as calls:
            img = sc.render(SAMPLES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        say(f"{label}: cold {SAMPLES}-sample frame {ms:.1f} ms, launches "
            f"{counts}, peak device memory {peak:.2f} GiB ({where})")
        if counts != MESH_COLD_LAUNCHES:
            fail(f"mesh: {label} launched {counts}, expected "
                 f"{MESH_COLD_LAUNCHES}")
        if not bool(torch.isfinite(sc._accum).all()) or img.shape != (
                1080, 1920, 3):
            fail(f"mesh: {label} frame {img.shape} is not finite")
        return img, hits_of(sc), calls

    # ---- 8a. replicated maps ------------------------------------------------
    cfg8 = dataclasses.replace(cfg, devices=MESH_DEVICES)
    scene = headless.build_scene(cfg8, mesh=mesh)
    if scene.height != 1088 or scene.mesh.size != MESH_DEVICES:
        fail(f"mesh: frame padded to {scene.height} rows")
    img_a, hit_a, calls = cold_burst(scene, "8a replicated")
    if "mesh_shadow_scan_fallback_single_device" in events:
        fail("mesh: the shadow scan fell back to one device")
    against("8a frame against phase 3's single-device frame", img_a, hit_a,
            img3, hit3)
    by = {}
    for name, call in calls:
        by.setdefault(name, []).append(call)
    hold("wedge 1 (phi0 1024 of 4096)", "shadow_factor", by["shadow_factor"][1])
    hold("wedge 1, heights", "resample_group_windows",
         by["resample_group_windows"][2])
    hold("wedge 1, bounce albedo", "resample_group_windows",
         by["resample_group_windows"][3])
    hold("strip 0, cold sample", "march_shade", by["march_shade"][0])
    hold("strip 0, warm sample", "march_shade", by["march_shade"][1])
    del calls, by

    # ---- 8b. the interactive session on the mesh ----------------------------
    sess = Session(scene, load_moon_features(None))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sess.frame()
    bright = scene.brightness
    recs = []
    for key, minutes in (("W", 15), ("W", 15), ("W", 15), ("Q", -15)):
        org, pf = scene._origins, scene._prefetch
        t0 = time.perf_counter()
        sess.change_time(minutes)
        sess.frame()
        torch.cuda.synchronize()
        recs.append(dict(
            key=key, ms=(time.perf_counter() - t0) * 1e3, dt=scene.dt_local,
            kept=scene._origins is org, flip=scene.last_flip_hit,
            consumed=pf is not None and scene._accum is pf["accum"],
            img=scene.display().copy(), hit=hits_of(scene),
            brightness=bright))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scene.set_brightness(bright + 10)
    sess.frame()
    torch.cuda.synchronize()
    reset_counts = kernels.launch_counts()
    recs.append(dict(key="brightness", ms=(time.perf_counter() - t0) * 1e3,
                     dt=scene.dt_local, kept=True, flip=False,
                     consumed=False, img=scene.display().copy(),
                     hit=hits_of(scene), brightness=bright + 10))
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    say("8b steps: " + "; ".join(
        f"{r['key']} {r['ms']:.1f} ms (windows kept {r['kept']}, "
        f"speculation consumed {r['consumed']}, flip {r['flip']})"
        for r in recs) + f"; the brightness reset launched {reset_counts}; "
        f"peak device memory {peak_b:.2f} GiB ({where})")
    say(f"8b kept-windows step (W, no speculation): {recs[0]['ms']:.1f} ms "
        f"key to synchronised frame ({where})")
    if not all(r["kept"] for r in recs[:4]):
        fail("mesh: a 15-minute step dropped the pose windows")
    if not (recs[1]["consumed"] and recs[2]["consumed"]):
        fail("mesh: the held W steps did not consume their speculation")
    if not recs[3]["flip"]:
        fail("mesh: the W -> Q flip missed the flip cache")
    if {k: v for k, v in reset_counts.items() if v} != {
            "march_shade": MESH_DEVICES}:
        fail(f"mesh: the brightness reset launched {reset_counts}")
    for r in recs:
        scene._prefetch = None
        scene._flip_cache = None
        scene._bounce = scene._bounce_basis = scene._bounce_key = None
        scene.update_view(r["dt"])
        scene.set_brightness(r["brightness"])
        scene.set_view_orientation(scene.view_orientation)
        img_c = scene.render(1)
        against(f"8b {r['key']} frame against the same view from cold "
                "caches", r["img"], r["hit"], img_c, hits_of(scene))
    # the replicated frame 8c is held against: the zoomed view, cold
    from moonrtx_tpu_torch.types import Camera

    cam = scene.camera
    zoom = Camera(eye=[c * MESH_BAND_ZOOM for c in cam.eye],
                  target=cam.target, up=cam.up, fov=cam.fov)
    scene._prefetch = None
    scene._flip_cache = None
    scene.update_view(cfg8.dt_local)        # 8c's scene starts there,
    scene._rng = np.random.default_rng(42)  # with a fresh scene's jitters
    scene.set_brightness(bright)
    scene.set_camera(zoom)
    img_z, hit_z, _ = cold_burst(scene, "8a replicated, zoomed to render "
                                 f"level {scene.mip_level()}")
    del sess, scene, recs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8c. the render level band-sharded ----------------------------------
    cfg8c = dataclasses.replace(cfg8, hbm_budget_gb=MESH_BAND_BUDGET_GB)
    scene = headless.build_scene(cfg8c, mesh=mesh)
    scene.set_camera(zoom)
    ob = scene.hbm_over_budget or {}
    say(f"8c plan at a {MESH_BAND_BUDGET_GB} GiB budget: banded mip levels "
        f"{sorted(scene._band_levels)}, albedo levels "
        f"{sorted(scene._band_alb_levels)}; projected "
        f"{ob.get('projected_bytes')} bytes against a budget of "
        f"{ob.get('budget_bytes')} bytes a device (render level "
        f"{scene.mip_level()})")
    if not scene.hf_sharded():
        fail("mesh: the render level is not band-sharded in 8c")
    img_c, hit_c, calls = cold_burst(scene, "8c banded")
    against("8c banded frame against 8a's replicated frame of the same "
            "view", img_c, hit_c, img_z, hit_z)
    k1 = [c for n, c in calls if n == "extract_group_windows"]
    hold("device 1's band-local extraction, heights",
         "extract_group_windows", k1[2])
    hold("device 1's band-local extraction, albedo",
         "extract_group_windows", k1[3])
    del calls, k1, scene
    scene_mod.log_event = real_log
    gc.collect()
    torch.cuda.empty_cache()


def timelapse_frame_ms(scene, img, out_dir: str) -> tuple[list, float]:
    """What one time-lapse frame costs on its own, for phase 7 to hold the
    interval between saves against: three 15-minute time steps, each with
    a 32-sample burst on the march path, from the phase-3 view
    (synchronised, ms each), and the mean of two PNG saves of a 1080p
    frame (ms)."""
    from datetime import timedelta

    import torch

    from moonrtx_tpu_torch.app import headless

    scene.backend = "pallas"
    scene.set_view_orientation(scene.view_orientation)
    scene._prefetch = None
    scene._flip_cache = None
    scene.update_view(scene.config.dt_local)
    scene.ensure_accumulated(SAMPLES)
    torch.cuda.synchronize()
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        scene.update_view(scene.dt_local + timedelta(minutes=15))
        scene.ensure_accumulated(SAMPLES)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    saves = []
    for _ in range(2):
        t0 = time.perf_counter()
        headless.save_image(img, os.path.join(out_dir, "save_probe.png"))
        saves.append((time.perf_counter() - t0) * 1e3)
    return steps, sum(saves) / len(saves)


def peak_rss_kb(pid: int, seen: int) -> int:
    """The larger of ``seen`` and process pid's resident set now or at its
    high-water mark (/proc: VmHWM and VmRSS where the kernel gives them,
    and statm's resident pages), in KiB."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmHWM:", "VmRSS:")):
                    seen = max(seen, int(line.split()[1]))
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        seen = max(seen, pages * os.sysconf("SC_PAGE_SIZE") // 1024)
    except (OSError, ValueError, IndexError):
        pass
    return seen


def run_cli(flags: list, here: str, env: dict, timeout_s: float) -> dict:
    """Run ``python -m moonrtx_tpu_torch`` with ``flags`` from ``here``:
    its exit code, wall seconds, output lines each with the seconds since
    the start at which it arrived, and its peak host RSS in GiB, read from
    /proc every 20 ms while it runs (None where /proc gives none; a
    child's rusage would count this process's own RSS at the fork)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "moonrtx_tpu_torch", *flags], cwd=here,
        env={**env, "PYTHONUNBUFFERED": "1"}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(timeout_s, proc.kill)
    timer.start()
    peak_kb = [0]

    def watch():
        while proc.poll() is None:
            peak_kb[0] = peak_rss_kb(proc.pid, peak_kb[0])
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    lines = [(time.perf_counter() - t0, line.rstrip("\n"))
             for line in proc.stdout]
    proc.wait()
    timer.cancel()
    watcher.join()
    return dict(rc=proc.returncode, wall_s=time.perf_counter() - t0,
                lines=lines, rss_gib=peak_kb[0] / 2**20 or None)


def read_png(path: str):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path))


def moon_share(img) -> float:
    """Share of the frame brighter than 8 levels: the Moon, whose night
    side earthshine lifts above that, while the star background stays
    below it on all but a few pixels."""
    return float((img.max(axis=-1) > 8).mean())


def cli_phase(cfg, img, kind: str, step_ms: list, save_ms: float,
              here: str, out_dir: str) -> None:
    """Phase 7: the CLI on the card, three runs of ``python -m
    moonrtx_tpu_torch`` as a user types them: a still frame on the blocked
    path (auto backend, two bounces, --devices 0), a 4-frame time-lapse on
    the march path, and the still frame with no card visible. Fails on any
    check; prints each run's wall time and peak host RSS and the interval
    between the time-lapse's saves."""
    import dataclasses

    import numpy as np

    from moonrtx_tpu_torch.app import cli

    def say(msg: str) -> None:
        print(f"# cli: {msg}", flush=True)

    th, tw = cfg.synth_shape
    base = ["--lat", "50.06", "--lon", "19.94", "--elevation", "219",
            "--time", "2024-04-15T21:00:00Z", "--synth-shape", f"{th}x{tw}",
            "--downscale", "1", "--shadow-accuracy", "10", "--devices", "0",
            "--headless", "--no-download"]
    still = base + ["--accumulation-frames", "8", "--indirect-bounces", "2",
                    "--save", os.path.join(out_dir, "cli_still.png")]
    timelapse = base + ["--backend", "pallas", "--accumulation-frames", "32",
                        "--indirect-bounces", "1", "--timelapse-frames", "4",
                        "--save", os.path.join(out_dir, "cli_tl.png")]
    nocard = base + ["--accumulation-frames", "8", "--indirect-bounces", "2",
                     "--save", os.path.join(out_dir, "cli_nocard.png")]
    # --devices 4: on a host with fewer cards make_mesh refuses and the run
    # exits non-zero naming them; on four cards it renders over them
    four = [("4" if f == "0" and base[i - 1] == "--devices" else f)
            for i, f in enumerate(base)]
    four += ["--accumulation-frames", "8", "--indirect-bounces", "1",
             "--save", os.path.join(out_dir, "cli_devices4.png")]
    import torch
    n_cards = torch.cuda.device_count()
    # the time-lapse's first frame is phase 3's frame: the configuration
    # its flags give must be phase 3's, the data files (absent here, so
    # None) and devices (0: every local device, one here) aside
    tl_cfg = cli.config_from_args(cli.parse_args(timelapse))
    tl_cfg = dataclasses.replace(tl_cfg, devices=1)
    for field in dataclasses.fields(cfg):
        a, b = getattr(tl_cfg, field.name), getattr(cfg, field.name)
        if a != b and not field.name.endswith("_file"):
            fail(f"cli: the time-lapse flags give {field.name}={a!r}, "
                 f"phase 3 renders {b!r}")
    for name in os.listdir(out_dir):
        if name.startswith("cli_"):
            os.remove(os.path.join(out_dir, name))
    env = {k: v for k, v in os.environ.items() if k != "MOONRTX_PLATFORM"}
    runs = {}
    for name, flags, extra in (("still", still, {}),
                               ("timelapse", timelapse, {}),
                               ("nocard", nocard,
                                {"CUDA_VISIBLE_DEVICES": ""}),
                               ("devices4", four, {})):
        r = run_cli(flags, here, {**env, **extra}, 400)
        runs[name] = r
        with open(os.path.join(out_dir, f"cli_{name}.log"), "w") as f:
            f.writelines(f"{t:9.3f} {line}\n" for t, line in r["lines"])
        rss = ("not measured" if r["rss_gib"] is None
               else f"{r['rss_gib']:.2f} GiB")
        say(f"{name}: exit {r['rc']}, wall {r['wall_s']:.2f} s, peak host "
            f"RSS {rss}")
        refused = name == "nocard" or (name == "devices4" and n_cards < 4)
        if not refused and r["rc"] != 0:
            tail = "\n".join(line for _, line in r["lines"][-30:])
            fail(f"cli: the {name} run exited {r['rc']}:\n{tail}")
        if name != "nocard":
            acc = [line for _, line in r["lines"]
                   if line.startswith("Accelerator: cuda (")]
            say(f"{name}: {acc}")
            if len(acc) != 1 or kind not in acc[0]:
                fail(f"cli: the {name} run names no card {kind!r}")

    r = runs["devices4"]
    said = [line for _, line in r["lines"]
            if line.startswith(("Error", "Saved:", "Devices:"))]
    say(f"--devices 4 on {n_cards} card(s): exit {r['rc']}, {said}")
    saved4 = os.path.exists(os.path.join(out_dir, "cli_devices4.png"))
    if n_cards < 4:
        if r["rc"] == 0 or saved4 or not any(
                "make_mesh(4)" in line and f"only {n_cards}" in line
                for line in said):
            fail("cli: --devices 4 on fewer cards did not refuse naming "
                 "the missing cards")
    elif not saved4 or not any(line.startswith("Devices: 4")
                               for line in said):
        fail("cli: --devices 4 on four cards did not render over them")

    frames = {"still": read_png(os.path.join(out_dir, "cli_still.png"))}
    if n_cards >= 4:
        frames["devices4"] = read_png(os.path.join(out_dir,
                                                   "cli_devices4.png"))
    for i in range(4):
        frames[f"tl{i}"] = read_png(os.path.join(out_dir,
                                                 f"cli_tl_{i:04d}.png"))
    for name, f in frames.items():
        share = moon_share(f)
        say(f"{name}: {f.shape} {f.dtype}, Moon covers {share:.4f}")
        if f.shape != (1080, 1920, 3) or f.dtype != np.uint8:
            fail(f"cli: {name} is {f.shape} {f.dtype}")
        if not 0.2 <= share <= 0.9:
            fail(f"cli: the Moon covers {share} of {name}")
    # frame 0 against phase 3's march frame: the same view, map, backend
    # and samples; a PNG has no hit buffer, so the Moon masks stand in
    st = frame_diff(frames["tl0"], img, frames["tl0"].max(axis=-1) > 8,
                    img.max(axis=-1) > 8)
    d_max = int(np.abs(frames["tl0"].astype(int) - img.astype(int)).max())
    say(f"time-lapse frame 0 against phase 3's march frame: mean |d| "
        f"{st['mean']:.4f}, p99 |d| {st['p99']:.1f}, share beyond 8 levels "
        f"{st['over8']:.5f}, Moon-mask agreement {st['hits']:.5f}, max |d| "
        f"{d_max} (tolerance: {FRAME_BOUNDS})")
    if not within_frame_bounds(st):
        fail("cli: time-lapse frame 0 disagrees with phase 3's frame")
    for i in range(1, 4):
        a, b = frames[f"tl{i - 1}"], frames[f"tl{i}"]
        moved = float((a != b).any(axis=-1).mean())
        say(f"time-lapse frames {i - 1} -> {i}: {moved:.5f} of the pixels "
            f"changed, mean |d| {np.abs(a.astype(int) - b).mean():.4f}")
        if moved == 0.0:
            fail(f"cli: time-lapse frames {i - 1} and {i} are equal")
    saved = [t for t, line in runs["timelapse"]["lines"]
             if line.startswith("Saved: ")]
    if len(saved) != 4:
        fail(f"cli: the time-lapse printed {len(saved)} Saved: lines")
    gaps = [round((b - a) * 1e3, 1) for a, b in zip(saved, saved[1:])]
    say(f"time-lapse: first save at {saved[0]:.2f} s, intervals between "
        f"saves {gaps} ms; one 15-minute step with a 32-sample burst alone "
        f"{[round(v, 1) for v in step_ms]} ms, one 1080p PNG save "
        f"{save_ms:.1f} ms")
    r = runs["nocard"]
    said = [line for _, line in r["lines"]
            if line.startswith(("Error", "Saved:"))]
    written = [n for n in os.listdir(out_dir) if n.startswith("cli_nocard")
               and not n.endswith(".log")]
    say(f"no card: exit {r['rc']}, {said}, files {written}")
    if r["rc"] == 0 or any(line.startswith("Saved:") for line in said) \
            or written:
        fail("cli: the run without a card did not refuse to render")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--synth-shape", default="11520x23040",
                    help="synthetic map HxW (23040x46080 = benchmark size)")
    ap.add_argument("--out", default="chip_smoke_out",
                    help="output directory (PNG, caches), relative to here")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "moonrtx_tpu_torch")):
        fail("the moonrtx_tpu_torch package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    out_dir = os.path.join(here, args.out)
    os.makedirs(out_dir, exist_ok=True)
    # synthetic maps and pyramid caches stay inside the checkout
    os.environ["MOONRTX_TPU_CACHE"] = os.path.join(out_dir, "cache")
    sys.path.insert(0, here)

    from datetime import datetime, timezone

    import numpy as np

    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.ops import (extract, march_shade, shadow_prefix,
                                       shadow_scan)
    from moonrtx_tpu_torch.types import Observer

    # ---- 1. the card -----------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"# card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)

    # ---- 2. build ----------------------------------------------------------
    kernels.build_all()
    print(f"# build: {kernels.build_seconds:.2f} s for "
          f"{len(kernels.SOURCES)} sources", flush=True)
    for src, log in kernels.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"#   {src}: {' | '.join(regs)}", flush=True)

    # ---- 3. the main path ------------------------------------------------
    th, tw = (int(v) for v in args.synth_shape.split("x"))
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=1920, height=1080, shadow_accuracy=10, backend="pallas",
        synth_shape=(th, tw), downscale=1).validate()
    t0 = time.time()
    scene = headless.build_scene(cfg)
    scene.update_view()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    print(f"# host set-up: {setup_s:.1f} s (map {scene.mip_shapes[0]} "
          f"{scene.mips[0].dtype}, upload {scene.upload_wall_s:.1f} s)",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    with kernels.recording() as calls:
        img = scene.render(SAMPLES)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    counts = kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"# cold first frame: {cold_s:.3f} s; launches {counts}; "
          f"peak device memory {peak_gib:.2f} GiB", flush=True)
    for name in PATH_KERNELS["pallas"]:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the march path")
    if counts["march_shade"] != 1 or counts["march_burst"] != 1:
        fail(f"march_shade launched {counts['march_shade']} and march_burst "
             f"{counts['march_burst']} times, expected 1 each (sample 0, "
             f"then samples 1-{SAMPLES - 1} in one burst)")
    accum = scene._accum
    if not bool(torch.isfinite(accum).all()):
        fail("the frame has non-finite values")
    if img.shape != (1080, 1920, 3) or img.dtype != np.uint8:
        fail(f"frame shape {img.shape} {img.dtype}")
    hit = (scene._hitbuf[..., 3] > 0).cpu().numpy()[:1080, :1920]
    moon = img[hit]
    lit = float((moon.max(axis=-1) > 8).mean())
    print(f"# frame: Moon covers {hit.mean():.4f} of it, lit fraction of "
          f"the Moon {lit:.4f}, frame mean {img.mean():.3f}", flush=True)
    if not (0.2 < hit.mean() < 0.9 and 0.05 < lit <= 1.0):
        fail(f"Moon coverage {hit.mean()} or lit fraction {lit} is off")
    png = os.path.join(out_dir, "main_path_1080p.png")
    headless.save_image(img, png)

    # warm re-burst: same pose, so the burst runs from the cached windows
    scene.reset_accumulation()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    scene.ensure_accumulated(SAMPLES)
    end.record()
    torch.cuda.synchronize()
    warm_ms = start.elapsed_time(end) / SAMPLES
    print(f"# warm re-burst: {warm_ms:.3f} ms per accumulation sample",
          flush=True)

    # ---- 3b. the blocked path, same scene and maps -------------------------
    # the backend switch tools/make_goldens.py makes; a view-orientation
    # set drops the pose caches (a set_camera to the same camera keeps
    # them), the sun's shadow and bounce maps stay
    scene.backend = "blocked"
    scene.set_view_orientation(scene.view_orientation)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with kernels.recording() as calls_blocked:
        t0 = time.time()
        scene.render(1)                      # pose caches + sample 0
        torch.cuda.synchronize()
        first_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        img_b = scene.render(BLOCKED_SAMPLES)
        torch.cuda.synchronize()
        sample_ms = (time.time() - t0) * 1e3 / (BLOCKED_SAMPLES - 1)
    counts_b = kernels.launch_counts()
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    print(f"# blocked path: pose caches {first_ms - sample_ms:.2f} ms "
          f"(first frame {first_ms:.2f} ms less one sample), "
          f"{sample_ms:.3f} ms per accumulation sample over "
          f"{BLOCKED_SAMPLES - 1} samples; launches {counts_b}; peak device "
          f"memory {peak_b:.2f} GiB", flush=True)
    if counts_b["extract_level_windows"] != K5_LAUNCHES_PER_POSE:
        fail(f"extract_level_windows launched "
             f"{counts_b['extract_level_windows']} times on the blocked "
             f"path, expected {K5_LAUNCHES_PER_POSE}")
    if scene._accum_n != BLOCKED_SAMPLES:
        fail(f"the blocked path accumulated {scene._accum_n} samples")
    if not bool(torch.isfinite(scene._accum).all()):
        fail("the blocked frame has non-finite values")
    if img_b.shape != img.shape or img_b.dtype != np.uint8:
        fail(f"blocked frame shape {img_b.shape} {img_b.dtype}")
    headless.save_image(img_b, os.path.join(out_dir, "blocked_1080p.png"))
    # different backends, same scene: the march path marches 12 coarse
    # steps on bf16 windows with bf16 shadow windows, the blocked path 24
    # on f32 windows, and the sample counts differ; they part on limb and
    # shadow-edge pixels (tests/test_blocked.py holds the reference's own
    # two backends to p98 <= 2 on interior pixels, < 2% beyond 8 levels)
    d = np.abs(img_b.astype(int) - img.astype(int)).max(axis=-1)
    hit_b = (scene._hitbuf[..., 3] > 0).cpu().numpy()[:1080, :1920]
    stats = dict(mean=float(d.mean()), p99=float(np.percentile(d, 99)),
                 over8=float((d > 8).mean()),
                 hits=float((hit_b == hit).mean()))
    print(f"# blocked frame against the march frame: mean |d| "
          f"{stats['mean']:.4f}, p99 |d| {stats['p99']:.1f}, share beyond 8 "
          f"levels {stats['over8']:.5f}, hit agreement {stats['hits']:.5f} "
          f"(tolerance: mean < 0.5, p99 <= 3, share < 0.005, hits >= 0.999)",
          flush=True)
    if not (stats["mean"] < 0.5 and stats["p99"] <= 3
            and stats["over8"] < 0.005 and stats["hits"] >= 0.999):
        fail("the blocked frame disagrees with the march frame")
    counts["extract_level_windows"] = counts_b["extract_level_windows"]
    calls = calls + calls_blocked

    # a single-level launch beside one advanced-indexing gather: the height
    # launch cut down to the blocks that read level 0 (the main path's own
    # launches pick among three levels, which no single call does)
    hcall = calls_blocked[0][1]
    sel = hcall["lvl_idx"] == 0
    one = dict(hcall, levels=hcall["levels"][:1],
               lvl_idx=hcall["lvl_idx"][sel].contiguous(),
               r0=hcall["r0"][sel].contiguous(),
               c0=hcall["c0"][sel].contiguous())
    k5_one, _ = device_ms(lambda: extract.extract_level_windows(**one),
                          KERNELS["extract_level_windows"]["kernel"], 30)
    lib_one = cuda_ms(library_call("extract_level_windows", one), 20)
    print(f"# extract_level_windows on the {int(sel.sum())} level-0 height "
          f"blocks alone: kernel {k5_one:.4f} ms, one advanced-indexing "
          f"gather (no decode) {lib_one:.4f} ms", flush=True)
    # the same for K1's height launch (whole groups of blocks)
    hcall = next(c for n, c in calls if n == "extract_group_windows")
    sel = torch.nonzero(hcall["lvl_idx"] == 0)[:, 0]
    sel = sel[:sel.numel() // hcall["group"] * hcall["group"]]
    one = dict(hcall, map_levels=(hcall["map_levels"][0][:1],),
               lvl_idx=hcall["lvl_idx"][sel].contiguous(),
               r0=hcall["r0"][sel].contiguous(),
               c0=hcall["c0"][sel].contiguous())
    k1_one, _ = device_ms(lambda: extract.extract_group_windows(**one),
                          KERNELS["extract_group_windows"]["kernel"], 30)
    lib_one = cuda_ms(library_call("extract_group_windows", one), 20)
    print(f"# extract_group_windows on {sel.numel()} level-0 height blocks "
          f"alone: kernel {k1_one:.4f} ms, one advanced-indexing gather (no "
          f"decode) {lib_one:.4f} ms", flush=True)

    # ---- 4. each kernel against its plain version, and its times -------
    plain = {"extract_group_windows": extract.extract_group_windows_plain,
             "extract_level_windows": extract.extract_level_windows_plain,
             "resample_group_windows": extract.resample_group_windows_plain,
             "shadow_factor": shadow_prefix.shadow_factor_plain,
             "march_shade": march_shade.march_shade_plain,
             "march_burst": march_shade.march_burst_plain,
             "bounce_from_parts": shadow_scan.bounce_from_parts_plain}
    wrapper = kernels.wrappers()
    # launches to replay: every call of the frame (K2 once, for sample 0)
    picked: dict = {name: [] for name in KERNELS}
    for name, call in calls:
        picked[name].append(call)
    report = []
    per_call = {}   # name -> device ms of all its replayed launches
    for name, items in picked.items():
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, lib=0.0)
        has_lib = True
        errs = {}       # output -> (error, tolerance) nearest its limit
        max_err = 0.0   # the main output's largest error over the launches
        bound_ops = 0.0
        passes = dict.fromkeys(KERNELS[name]["kernel"], 0.0)
        for call in items:
            got = wrapper[name](**call)
            ref = plain[name](**call)
            torch.cuda.synchronize()
            checks = compare(name, call, got, ref)
            max_err = max(max_err, checks[0][1])
            for what, err, tol in checks:
                err0, tol0 = errs.get(what, (0.0, tol))
                if err * tol0 >= err0 * tol:
                    errs[what] = (err, tol)
            b_ms, b_by = bound_of(name, call, got)
            k_ms, by_pass = device_ms(lambda: wrapper[name](**call),
                                      KERNELS[name]["kernel"], 30,
                                      launches_per_call(name, call))
            for kernel, ms in by_pass.items():
                passes[kernel] += ms
            p_ms = cuda_ms(lambda: plain[name](**call), 2)
            if name == "resample_group_windows":
                # the bound counts a texel once, but windows overlap and
                # every block reads its own whole window (from L2)
                lv = call["levels"][0]
                reread = got.shape[0] * call["wh"] * call["ww"] \
                    * lv.element_size()
                print(f"#   resample_group_windows launch: {lv.dtype} "
                      f"levels, {got.shape[0]} blocks: {k_ms:.4f} ms, bound "
                      f"{b_ms:.4f} ms, plain {p_ms:.3f} ms; the blocks read "
                      f"{reread / 1e6:.1f} MB of windows in all, "
                      f"{reread / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
                      f"device-memory rate", flush=True)
            if name in ("extract_group_windows", "extract_level_windows"):
                maps = call.get("map_levels", call.get("levels"))
                if isinstance(maps[0], torch.Tensor):
                    maps = (maps,)
                lv = maps[0][0]
                print(f"#   {name} launch: {len(maps)} map(s) of "
                      f"{lv.dtype} levels {tuple(lv.shape)}, out {got.dtype} "
                      f"{tuple(got.shape)}: {k_ms:.4f} ms, bound {b_ms:.4f} "
                      f"ms ({b_ms / k_ms:.0%} of it reached), plain "
                      f"{p_ms:.3f} ms", flush=True)
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            bound_ops += b_ms if b_by == "operations" else 0.0
            lib = library_call(name, call)
            if lib is None:
                has_lib = False
            else:
                tot["lib"] += cuda_ms(lib, 20)
            del got, ref
        n = len(items)
        entry = dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=counts[name],
            max_abs_err=max_err, ms=tot["ms"] / n,
            plain_ms=tot["plain_ms"] / n, bound_ms=tot["bound_ms"] / n,
            bound_by=("operations" if bound_ops > 0.5 * tot["bound_ms"]
                      else "bytes"),
            library_ms=(tot["lib"] / n) if has_lib else None)
        report.append(entry)
        per_call[name] = tot["ms"]
        err_text = ", ".join(f"{what} {err:.3g} (tolerance {tol:.3g})"
                             for what, (err, tol) in errs.items())
        print(f"# {name}: max |err| {max_err:.3g}; nearest its tolerance: "
              f"{err_text}; {entry['ms']:.4f} ms per "
              f"launch (device), plain "
              f"{entry['plain_ms']:.3f} ms, bound {entry['bound_ms']:.4f} ms "
              f"({entry['bound_by']}), library {entry['library_ms']}",
              flush=True)
        if len(passes) > 1:
            print(f"#   {name} by pass: " + ", ".join(
                f"{kernel} {ms / n:.4f} ms" for kernel, ms in passes.items()),
                flush=True)
    for entry in report:
        if entry["name"] in PER_POSE:
            now, was = per_call[entry["name"]], EARLIER_MS[entry["name"]]
            print(f"# {entry['name']}: {now:.4f} ms per pose in "
                  f"{entry['launches']} launches, the earlier design took "
                  f"{was:.4f} ms in six (PERF.md): {was / now:.2f}x",
                  flush=True)
        elif entry["name"] in EARLIER_MS:
            was = EARLIER_MS[entry["name"]]
            print(f"# {entry['name']}: {entry['ms']:.4f} ms per launch, the "
                  f"earlier design took {was:.4f} ms (PERF.md): "
                  f"{was / entry['ms']:.2f}x", flush=True)

    # ---- 4b. inputs that a wrong split of the work gets wrong ------------
    from moonrtx_tpu_torch import constants, hard_cases

    def on_card(a):
        return torch.from_numpy(a).cuda()

    for grid in ((1536, 4096), (2304, 4096), (384, 2048)):
        worst, inner = 0.0, 1.0
        for family in hard_cases.SHADOW_FAMILIES:
            hs, st, ct = (on_card(a) for a in hard_cases.shadow_hard_case(
                family, *grid, seed=11))
            call = dict(hs=hs, st=st, ct=ct,
                        sun_ang_radius=hard_cases.SHADOW_SAR,
                        moon_radius=constants.MOON_RADIUS)
            got = shadow_prefix.shadow_factor(**call)
            ref = shadow_prefix.shadow_factor_plain(**call)
            torch.cuda.synchronize()
            worst = max(worst,
                        compare("shadow_factor", call, got, ref)[0][1])
            inner = min(inner, float(((ref > 0.0) & (ref < 1.0))
                                     .float().mean()))
            del got, ref
        print(f"# shadow_factor on hard inputs, grid {grid}: "
              f"{len(hard_cases.SHADOW_FAMILIES)} families, max |err| "
              f"{worst:.3g} (tolerance 1e-4), at least {inner:.3f} of the "
              f"factors strictly inside (0, 1)", flush=True)
        if inner < 0.25:
            fail("the hard shadow inputs saturate: they test nothing")
    for dtype in hard_cases.RESAMPLE_DTYPES:
        worst = (0.0, 1.0)
        families = (hard_cases.RESAMPLE_FAMILIES
                    + hard_cases.RESAMPLE_GUARD_FAMILIES)
        for family in families:
            case = hard_cases.resample_hard_case(family, dtype, seed=12)
            call = hard_cases.resample_case_with(case, on_card)
            got = extract.resample_group_windows(**call)
            ref = extract.resample_group_windows_plain(**call)
            torch.cuda.synchronize()
            _, err, tol = compare("resample_group_windows", call, got,
                                  ref)[0]
            if err * worst[1] >= worst[0] * tol:
                worst = (err, tol)
        print(f"# resample_group_windows on hard inputs, {dtype}: "
              f"{len(families)} families, nearest its tolerance: max |err| "
              f"{worst[0]:.3g} (tolerance {worst[1]:.3g})", flush=True)
    for dtype in hard_cases.EXTRACT_DTYPES:
        worst = {"extract_group_windows": 0.0, "extract_level_windows": 0.0}
        families = (hard_cases.EXTRACT_FAMILIES
                    + hard_cases.EXTRACT_GUARD_FAMILIES)
        for family in families:
            case = hard_cases.extract_hard_case(family, dtype, seed=14)
            k1, k5 = hard_cases.extract_case_calls(
                case, on_card, lambda t: t.to(torch.bfloat16))
            if k1 is not None:
                k1["out_dtype"] = (torch.bfloat16 if dtype == "bfloat16"
                                   else torch.float32)
            for name, call in (("extract_group_windows", k1),
                               ("extract_level_windows", k5)):
                if call is None:
                    continue
                got = wrapper[name](**call)
                ref = plain[name](**call)
                torch.cuda.synchronize()
                worst[name] = max(worst[name],
                                  compare(name, call, got, ref)[0][1])
        print(f"# extraction on hard inputs, {dtype}: {len(families)} "
              f"families, bit-equal to the plain versions; max |err| K1 "
              f"{worst['extract_group_windows']:.3g}, K5 "
              f"{worst['extract_level_windows']:.3g} (tolerance 0)",
              flush=True)

    # ---- 5. a small input: kernels against the plain path on the CPU ----
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.ops import shadow_scan

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    rs = float(elev.max())
    elev = (elev / rs).astype(np.float32)
    # the gather reference renders f32 scenes only (a quantized scene
    # resolves "reference" to "blocked")
    for backend, quantize in (("pallas", "i16"), ("blocked", "i16"),
                              ("reference", "off")):
        small = RenderConfig(
            observer=Observer(50.06, 19.94, 219),
            dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
            width=256, height=144, shadow_accuracy=4, backend=backend,
            quantize=quantize).validate()
        frames = {}
        for dev in ("cuda", "cpu"):
            s = MoonScene(small, elev, rs, albedo, None, device=dev)
            if s.backend != backend:
                fail(f"backend {backend} resolved to {s.backend}")
            s.update_view()
            frames[dev] = (s.render(4).astype(int),
                           s._hitbuf[..., 3].cpu().numpy() > 0)
        d = np.abs(frames["cuda"][0] - frames["cpu"][0]).max(axis=-1)
        hit_agree = float((frames["cuda"][1] == frames["cpu"][1]).mean())
        print(f"# small scene, {backend}: card vs plain on the CPU: p99 |d| "
              f"{np.percentile(d, 99):.1f}, mean |d| {d.mean():.4f}, hit "
              f"agreement {hit_agree:.5f}", flush=True)
        if not (np.percentile(d, 99) <= 2 and d.mean() < 0.2
                and hit_agree >= 0.999 and frames["cpu"][1].mean() > 0.2):
            fail(f"small scene, {backend}: the card disagrees with the "
                 "plain path on the CPU")

    # K5's other caller: a scan whose resample group does not divide its
    # block count cuts every level's windows with K5
    tex = torch.from_numpy(np.ascontiguousarray(s.mips[0].cpu().numpy()))
    sh, sw_ = s.mip_shapes[0]
    sun = torch.tensor([0.6, -0.7, 0.3])
    sun = sun / torch.linalg.norm(sun)
    heights = {}
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        basis = torch.stack(shadow_scan.sun_frame_basis(sun.to(dev)))
        _, heights[dev] = shadow_scan.scan_wedge(
            tex.to(dev), basis, 0.0046, sh, sw_, 64, 64, 512, 0, 512,
            blocked_resample=True, return_heights=True, resample_group=7)
    torch.cuda.synchronize()
    n_k5 = kernels.launch_counts()["extract_level_windows"]
    spread = float(heights["cpu"].max() - heights["cpu"].min())
    err = float((heights["cuda"].cpu() - heights["cpu"]).abs().max())
    print(f"# ungrouped scan resample: {n_k5} K5 launches, heights on the "
          f"card within {err:.3g} of the CPU's (tolerance {4e-3 * spread:.3g}"
          f", 4e-3 of their spread: the bf16 row mix)", flush=True)
    if not (1 <= n_k5 <= 3 and err <= 4e-3 * spread):
        fail("the ungrouped scan resample disagrees with the CPU")

    # ---- 6. the interactive session ----------------------------------------
    print(f"# session: card {card}", flush=True)
    session_phase(scene)

    # ---- 7. the CLI on the card ------------------------------------------
    step_ms, save_ms = timelapse_frame_ms(scene, img, out_dir)
    del scene, accum, calls, calls_blocked, picked, hcall, one
    gc.collect()
    torch.cuda.empty_cache()
    cli_phase(cfg, img, kind, step_ms, save_ms, here, out_dir)

    # ---- 8. the mesh on the card -------------------------------------------
    mesh_phase(cfg, img, hit, card, out_dir)

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
