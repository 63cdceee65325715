"""One run of one cell: set-up, warm-up, the measured window, the metrics,
then the comparison with the reference."""

from __future__ import annotations

import contextlib
import gc
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

from harness import check, program, spec, trace, traffic
from harness.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "moonrtx_tpu")


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``moonrtx_tpu_torch`` is not
    ``moonrtx_tpu``."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a metric's reader reads (portbench/metrics/<metric>.py: read)."""

    def __init__(self, cell: str, on_card: bool):
        self.cell = cell
        self.on_card = on_card
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.latencies_ms: list = []
        self.spans: dict = {}          # host spans: name -> [(t0, t1)] s
        self.launches: list = []       # per request: {kernel: launches}
        self.trace: Optional[trace.Trace] = None
        self._probe = None
        self._probe_fn = None

    @property
    def completed(self) -> int:
        return len(self.latencies_ms)

    def span_ms(self, name: str) -> list:
        return [(t1 - t0) * 1e3 for t0, t1 in self.spans.get(name, [])]

    def probe(self) -> Optional[dict]:
        """One more request of the cell's traffic, after the window, with
        every kernel launch recorded ({"calls": [(wrapper, args)],
        "trace": Trace}); None where the run cannot make one."""
        if self._probe is None and self._probe_fn is not None:
            self._probe = self._probe_fn()
        return self._probe


def _note(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(on_card: bool) -> None:
    if on_card:
        import torch

        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, root: Path = ROOT, device=None,
             control: bool = False, readings: bool = False) -> dict:
    """Run cell ``name`` once and return the result object. ``device`` None
    is the card; "cpu" runs the port's plain path on the host, for the
    tests (its result reports no device metric). ``control`` also judges
    the reference in bfloat16 in the program's place on the same requests
    (portbench/control.py): its readings under "control"; with it or
    ``readings``, every number the check reads of the program is under
    "program")."""
    import torch

    from moonrtx_tpu_torch import kernels

    bench = spec.load_benchmark(root)
    w = spec.workload(bench, name)
    cfg = spec.config(bench, w["config"], root)
    mix = spec.mix(w["traffic"], root)
    e2e, layer = spec.metrics_of(bench, name)
    on_card = device is None
    maps = program.load_maps(cfg)
    spans = program.Spans(profiled=traced)
    user = program.build(cfg, mix, maps, spans, device)
    warm = traffic.warmup(mix, traffic.parse_dt(cfg["start"]))
    # the state of the program's generator before the last request that
    # drew from it: the jitters of the frame on show (check.jitters)
    drew = {"state": user.rng_state()}
    for r in warm:
        before = user.rng_state()
        user.do(r)
        if user.rng_state() != before:
            drew["state"] = before
    _sync(on_card)
    spans.clear()

    ctx = Context(name, on_card)
    stream = traffic.requests(mix, seed)
    wanted = set(traffic.checked_indices(mix, seed))
    events, captured = [], []
    attempted = failed = 0
    capture_s = 0.0
    prev = kernels.launch_counts()
    prof_cm = trace.profiled() if traced else contextlib.nullcontext()
    with prof_cm as prof:
        window_cm = contextlib.nullcontext()
        if traced:
            from torch.profiler import record_function
            window_cm = record_function(trace.WINDOW)
        with window_cm:
            w0 = time.perf_counter()
            ctx.setup_s = w0 - t_start
            while time.perf_counter() - w0 - capture_s < seconds:
                req = next(stream)
                attempted += 1
                before = user.rng_state()
                t0 = time.perf_counter()
                try:
                    user.do(req)
                except Exception:
                    traceback.print_exc()
                    failed += 1
                    break
                ctx.latencies_ms.append((time.perf_counter() - t0) * 1e3)
                if user.rng_state() != before:
                    drew["state"] = before
                events.append(req)
                cur = kernels.launch_counts()
                ctx.launches.append({k: cur[k] - prev[k] for k in cur})
                prev = cur
                if len(events) - 1 in wanted:
                    c0 = time.perf_counter()
                    with spans("capture"):
                        captured.append((1 + len(warm) + len(events) - 1,
                                         *user.capture(), drew["state"]))
                    capture_s += time.perf_counter() - c0
            w1 = time.perf_counter()
    _sync(on_card)
    if traced:
        _note(f"profiler stopped {time.perf_counter() - w1:.1f} s after "
              "the window")
    ctx.window_s = w1 - w0 - capture_s
    ctx.spans = spans.by_name
    peak = torch.cuda.max_memory_allocated() if on_card else None
    _note(f"window: {len(events)} requests in {ctx.window_s:.3f} s "
          f"({capture_s:.3f} s of captures left out); set-up "
          f"{ctx.setup_s:.3f} s")
    if traced:
        t0 = time.perf_counter()
        ctx.trace = trace.collect(prof)
        _note(f"trace: {len(ctx.trace.device)} device operations read in "
              f"{time.perf_counter() - t0:.1f} s")
        if on_card:
            ctx._probe_fn = lambda: _probe(user, stream, kernels)

    metrics = {}
    for m in (layer if traced else e2e):
        if m["source"] == "device_trace" and not on_card:
            continue
        value = spec.reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if traced and on_card:
        device_info["busy_s"] = ctx.trace.busy_s()
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}

    # the program's state goes before the reference runs
    user.close()
    del user, ctx, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    views = program.view_states(cfg, mix, warm + events)
    got, ctl = check.judge(cfg, mix, captured, views, maps,
                           device or "cuda", control=control)
    _note(f"reference: {got['n']} requests compared in "
          f"{time.perf_counter() - t0:.1f} s")
    limits = cfg["check"]
    result["correct"] = failed == 0 and check.verdict(got, limits)
    result["checks"] = {k: {"value": got[k], "limit": limits[k]}
                        for k in check.NAMES if k in limits}
    result["checks"]["requests_compared"] = {"value": got["n"], "limit": 1}
    if ctl is not None or readings:
        result["program"] = {k: got[k] for k in check.NAMES}
    if ctl is not None:
        result["control"] = {k: ctl[k] for k in check.NAMES}
        result["control_correct"] = check.verdict(ctl, limits)
    result["checks"] = result.pop("checks")         # still the last key
    return result


def _probe(user, stream, kernels) -> dict:
    """The next request of the stream under kernels.recording() and the
    profiler, synchronised."""
    import torch

    _sync(True)
    with trace.profiled() as prof:
        from torch.profiler import record_function

        with record_function(trace.WINDOW):
            with kernels.recording() as calls:
                user.do(next(stream))
            torch.cuda.synchronize()
    return {"calls": list(calls), "trace": trace.collect(prof)}
