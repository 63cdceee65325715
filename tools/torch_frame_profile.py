#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's requests spend their time, on one card, by
the program's own spans (moonrtx_tpu_torch/utils/profiling.py).

    python3 tools/torch_frame_profile.py [--synth-shape 11520x23040]
        [--backend pallas|blocked|reference] [--root CHECKOUT]
    python3 tools/torch_frame_profile.py --cell blocked.held [--seed N]
        [--root CHECKOUT]

Builds chip_smoke.py's main-path scene (1920x1080, shadow accuracy 10,
synthetic LOLA-sized int16 map) on the chosen backend: "pallas" (the
march kernel, 32 samples in a burst; the default), "blocked" (per-block
windows cut by K5, march and shading in plain torch ops, 8 samples one at
a time) or "reference" (plain gathers; resolves to "blocked" on this
quantized map). A request is a steady cold view: the date moves by a day
(new sun, so the shadow scan, the bounce pyramid and the pose windows are
rebuilt), then the frame is rendered and copied to the host.

With ``--cell`` a request is instead one event of a session cell of
BENCHMARK.json (blocked.held: a held Q/W step, a scrub step or a 2-px
drag, each followed by Session.frame(1)), built and drawn by the
benchmark's own harness (portbench/harness: the cell's configuration,
maps and traffic, ``--seed`` drawing the events) after the mix's
warm-up. ``--root`` runs the port of another checkout (a ``git archive``
of another commit) under this checkout's harness, so two commits can be
profiled in turns on one card.

Two views (ten events) warm up untraced; the next five views (40 events)
run under torch.profiler. It
prints, per program span, the ranges, host ms, device ms and device idle
ms per view: device work belongs to every span open when it was launched
(its runtime launch, found by correlation id), idle time to the innermost
span the host was in. Then the window's device busy time (the union of
the device operations' intervals) and idle share, the idle time by
innermost span, the counters' changes and the top device operations.
Writes the chrome trace to chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import sys
import time
from collections import defaultdict
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "moonrtx."
OUTSIDE = "outside"


def union(intervals) -> list:
    """Disjoint sorted cover of ``(start, end)`` intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy, w0: float, w1: float) -> list:
    """The parts of [w0, w1] that no interval of ``busy`` covers."""
    out, t = [], w0
    for s, e in union(busy):
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def innermost(spans) -> list:
    """Cut the time that ``(start, end, name)`` spans cover into sorted
    pieces ``(start, end, name)``, each named by the innermost span open
    over it (spans nest, as calls on one thread do)."""
    pieces, stack, t = [], [], 0.0

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for s, e, name in sorted(spans, key=lambda v: (v[0], -v[1])):
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    close(float("inf"))
    return pieces


def idle_by_span(idle, spans) -> dict:
    """Seconds of the ``idle`` intervals that fall inside each span's host
    intervals, the innermost span winning; the rest under OUTSIDE."""
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    out: dict = defaultdict(float)
    for g0, g1 in idle:
        covered = 0.0
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            d = min(e, g1) - max(s, g0)
            if d > 0:
                out[name] += d
                covered += d
            k += 1
        out[OUTSIDE] += (g1 - g0) - covered
    return dict(out)


def read_events(prof):
    """(program spans [(s, e, name)], device operations [(s, e, name,
    launch time or None)], window (s, e)) from a finished profiler, in
    microseconds. A device operation's launch time is that of the host
    runtime call with its correlation id or, where none was recorded, the
    start of the host operator it is linked to."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, device, launch_at, op_at = [], [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        name = ev.name()
        if ev.device_type() == cuda:
            device.append((s, e, name, ev.correlation_id(),
                           ev.linked_correlation_id()))
            continue
        if name.startswith("cu"):              # a CUDA API call (the launch)
            launch_at[ev.correlation_id()] = s
        else:
            op_at[ev.correlation_id()] = s
        if name.startswith(PREFIX):
            spans.append((s, e, name[len(PREFIX):]))
    device = [(s, e, n, launch_at.get(c, op_at.get(lc) if lc else None))
              for s, e, n, c, lc in device]
    w0 = min([s for s, _, _ in spans] + [s for s, *_ in device])
    w1 = max([e for _, e, _ in spans] + [e for _, e, *_ in device])
    return spans, device, (w0, w1)


def span_table(spans, device, window) -> dict:
    """Per span name: ranges, host us, device us (operations launched while
    a range of it was open, each once) and idle us (innermost); and the
    window's busy and idle us, the idle split and the device us whose
    launch was found."""
    by_name: dict = defaultdict(list)
    for s, e, name in spans:
        by_name[name].append((s, e))
    rows = {}
    for name, iv in by_name.items():
        cover = union(iv)
        starts = [s for s, _ in cover]
        dev = 0.0
        for s, e, _, t in device:
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= cover[k][1]:
                dev += e - s
        rows[name] = dict(ranges=len(iv), host_us=sum(e - s for s, e in iv),
                          device_us=dev, idle_us=0.0)
    w0, w1 = window
    busy = union((max(s, w0), min(e, w1)) for s, e, *_ in device)
    idle = gaps(busy, w0, w1)
    split = idle_by_span(idle, spans)
    for name, us in split.items():
        if name in rows:
            rows[name]["idle_us"] = us
    return dict(rows=rows, window_us=w1 - w0,
                busy_us=sum(e - s for s, e in busy),
                idle_split=split,
                launched_us=sum(e - s for s, e, _, t in device
                                if t is not None),
                device_us=sum(e - s for s, e, *_ in device))


def view_requests(backend: str, synth_shape: str):
    """(request, traced requests, warm-up requests) of cold views of
    chip_smoke.py's main-path scene on ``backend``."""
    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.types import Observer

    th, tw = (int(v) for v in synth_shape.split("x"))
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=1920, height=1080, shadow_accuracy=10, backend=backend,
        synth_shape=(th, tw), downscale=1).validate()
    scene = headless.build_scene(cfg)
    n = 32 if scene.backend == "pallas" else 8
    print(f"# backend {backend} -> {scene.backend}; cold views of {n} "
          "samples, the date a day apart")

    def request():
        scene.update_view(scene.dt_local + timedelta(days=1))
        scene.render(n)

    return request, 5, 2


def cell_requests(cell: str, seed: int):
    """(request, traced requests, warm-up requests) of the events of a
    session cell, through the benchmark's harness: its program (the
    scene and Session of the cell's configuration on its maps), its
    warm-up, then the events its traffic draws from ``seed``."""
    sys.path.insert(0, os.path.join(HERE, "portbench"))
    from harness import program, spec, traffic

    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = spec.config(bench, w["config"])
    mix = spec.mix(w["traffic"])
    if mix["user"] != "session":
        raise SystemExit(f"{cell} is not a session cell")
    user = program.build(cfg, mix, program.load_maps(cfg), program.Spans())
    print(f"# cell {cell}: backend {user.session.scene.backend}, events "
          f"of {w['traffic']} drawn from seed {seed}, each then "
          f"Session.frame({mix['samples']})")
    for r in traffic.warmup(mix, traffic.parse_dt(cfg["start"])):
        user.do(r)
    stream = traffic.requests(mix, seed)
    return (lambda: user.do(next(stream))), 40, 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synth-shape", default="11520x23040")
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "blocked", "reference"))
    ap.add_argument("--cell", default=None,
                    help="a session cell of BENCHMARK.json: its events")
    ap.add_argument("--seed", type=int, default=2612000021)
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose port runs")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = os.path.join(HERE, "chip_smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    os.environ["MOONRTX_TPU_CACHE"] = os.path.join(out_dir, "cache")
    sys.path.insert(0, os.path.abspath(args.root))
    from moonrtx_tpu_torch.utils import profiling

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"# card: {card}; the port of {os.path.abspath(args.root)}")
    if args.cell:
        request, n_req, n_warm = cell_requests(args.cell, args.seed)
    else:
        request, n_req, n_warm = view_requests(args.backend,
                                               args.synth_shape)
    for _ in range(n_warm):
        request()
    torch.cuda.synchronize()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_req):
            request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    after = profiling.counters()
    trace = os.path.join(out_dir, "frame_trace.json")
    prof.export_chrome_trace(trace)

    spans, device, window = read_events(prof)
    t = span_table(spans, device, window)
    print(f"# traced: {n_req} requests, wall {wall_ms:.2f} ms "
          f"({wall_ms / n_req:.2f} ms a request, profiler on); window "
          f"{t['window_us'] / 1e3:.2f} ms, device busy "
          f"{t['busy_us'] / 1e3:.2f} ms, idle share "
          f"{1 - t['busy_us'] / t['window_us']:.3f}; launch found for "
          f"{t['launched_us'] / max(t['device_us'], 1e-9):.3f} of the "
          "device time")
    print("# span                ranges/req  host ms/req  device ms/req  "
          "idle ms/req")
    for name, r in sorted(t["rows"].items(), key=lambda kv: -kv[1]["host_us"]):
        print(f"#   {name:20s} {r['ranges'] / n_req:9.2f} "
              f"{r['host_us'] / 1e3 / n_req:12.3f} "
              f"{r['device_us'] / 1e3 / n_req:14.3f} "
              f"{r['idle_us'] / 1e3 / n_req:12.3f}")
    idle_total = sum(t["idle_split"].values())
    print("# idle by program span: " + ", ".join(
        f"{k} {v / 1e6:.4f} s ({100 * v / idle_total:.1f}%)"
        for k, v in sorted(t["idle_split"].items(), key=lambda kv: -kv[1])))
    moved = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    print("# counters over the traced requests: " + ", ".join(
        f"{k} {v}" for k, v in sorted(moved.items())))
    by_op: dict = defaultdict(lambda: [0.0, 0])
    for s, e, name, _ in device:
        by_op[name][0] += e - s
        by_op[name][1] += 1
    for name, (us, cnt) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"#   {us / 1e3:9.3f} ms  x{cnt:<5d} {name[:90]}")
    print(f"# trace: {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
