"""The traced run: torch.profiler over the window, reduced to what the
per-layer readers and the breakdown need.

Device operations are the profiler's device-side events (kernels, copies,
sets). Busy time is the union of their intervals, so operations that
overlap count once. Each benchmark span (a ``record_function`` range
``pb.<name>`` on the host) also shows on the device as the range from the
first to the last operation launched inside it; the device time of a
span is the time of the operations inside those ranges. That holds for
work on one stream, as the port issues it (the held-key speculation
included). An idle gap is a stretch of the window in which no device
operation ran; it is named by the innermost benchmark span the host was
in when it began. The profiler's events are read raw (not through
``prof.events()``, which builds a tree of every host operation and takes
minutes for a window of this length).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

from harness import stats

WINDOW = "pb.window"


@contextlib.contextmanager
def profiled():
    """A profiler over the block (host ranges and device operations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


class Trace:
    """device: [(start_us, end_us, name)] sorted by start; on_device:
    {span: [(start_us, end_us)]} (the spans' device ranges); host:
    {span: [(start_us, end_us)]}; window: (start_us, end_us)."""

    def __init__(self, device, on_device, host, window):
        self.device = sorted(device)
        self.on_device = on_device
        self.host = host
        self.window = window
        self._starts = [s for s, _, _ in self.device]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        w0, w1 = self.window
        return stats.union_length(
            (max(s, w0), min(e, w1)) for s, e, _ in self.device) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def device_ms(self, span: str) -> float:
        """Device ms of the operations launched inside every instance of a
        benchmark span."""
        total = 0.0
        for s, e in self.on_device.get(span, []):
            k = bisect.bisect_left(self._starts, s)
            while k < len(self.device) and self.device[k][0] < e:
                total += min(self.device[k][1], e) - self.device[k][0]
                k += 1
        return total / 1e3

    def kernel_ms(self, name_part: str) -> float:
        """Device ms of the operations whose name contains ``name_part``."""
        return sum(e - s for s, e, n in self.device if name_part in n) / 1e3

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name in self.device:
            by[name] += (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest idle gaps, [span the host was in, seconds]."""
        w0, w1 = self.window
        found = stats.gaps(((s, e) for s, e, _ in self.device), w0, w1)
        found.sort(key=lambda g: g[0] - g[1])
        flat = sorted((s, e, name) for name, v in self.host.items()
                      for s, e in v)
        out = []
        for g0, g1 in found[:n]:
            inner, best = "outside the spans", None
            for s, e, name in flat:
                if s > g0:
                    break
                if e > g0 and (best is None or s >= best):
                    inner, best = name, s
            out.append([inner, (g1 - g0) / 1e6])
        return out


def collect(prof) -> Trace:
    """Reduce a finished profiler to a Trace. The window is the profiler
    range WINDOW that the harness opens around the measured requests."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, on_device, host = [], defaultdict(list), defaultdict(list)
    window = None
    for ev in prof.profiler.kineto_results.events():
        # host operations other than the benchmark's ranges are skipped
        # before anything else is read from them: most events are those
        on_card = ev.device_type() == cuda
        if not on_card and not ev.is_user_annotation():
            continue
        name = ev.name()
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        if on_card:
            if name.startswith("pb."):
                on_device[name[3:]].append((s, e))
            else:
                device.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        elif name.startswith("pb."):
            host[name[3:]].append((s, e))
    if window is None:
        raise RuntimeError("the profiler recorded no window range")
    return Trace(device, dict(on_device), dict(host), window)
