"""Profiling: the program's spans and counters, and frame-time statistics.

``span(name)`` marks a region of the program in a torch.profiler trace,
as a ``with`` block or as a function decorator. While no profiler is
active it costs one check of the profiler's own enabled flag and records
nothing. While one is, the region is a profiler range named
``moonrtx.<name>`` on the profiler's clock, the clock of the device
events; spans nest as the calls do. The range is an operator range
(``RecordScope.FUNCTION``), not a user annotation: the profiler then
gives it no device-side copy, and the device work launched inside it is
found through the launches' correlation ids (tools/torch_frame_profile.py
reads them so).

``count(name, n)`` adds to a named counter, always on; ``counters()``
copies them all. A kernel's launches are the counter
``launch.<wrapper>`` (kernels.launch counts them).

FrameStats (a copy of the reference's) feeds the status bar.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict, deque
from typing import Optional

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

PREFIX = "moonrtx."

_counts: defaultdict = defaultdict(int)


class span:
    """A named region of the program in a profiler trace (module doc).

    ``with span("scene.pose"): ...`` or ``@span("scene.update_view")``.
    With ``once``, a decorated function opens no second range while the
    same span is already open on the thread (an event that calls another
    event is one event)."""

    __slots__ = ("name", "_rf", "_open")

    def __init__(self, name: str, once: bool = False):
        self.name = name
        self._rf = None
        self._open = threading.local() if once else None

    def __enter__(self):
        if _profiler_enabled():
            self._rf = _RecordFunctionFast(PREFIX + self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name, opened = PREFIX + self.name, self._open

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            if opened is None:
                with _RecordFunctionFast(name):
                    return fn(*args, **kwargs)
            if getattr(opened, "depth", 0):
                return fn(*args, **kwargs)
            opened.depth = 1
            try:
                with _RecordFunctionFast(name):
                    return fn(*args, **kwargs)
            finally:
                opened.depth = 0

        return traced


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> dict:
    """A copy of every counter."""
    return dict(_counts)


def reset(prefix: str) -> None:
    """Set every counter whose name starts with ``prefix`` to 0."""
    for name in _counts:
        if name.startswith(prefix):
            _counts[name] = 0


class FrameStats:
    """Rolling frame-time statistics (for the status bar)."""

    def __init__(self, window: int = 60):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def reset(self) -> None:
        self.times.clear()
        self._last = None

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    @property
    def frame_ms(self) -> float:
        if not self.times:
            return 0.0
        return sum(self.times) / len(self.times) * 1000.0

    def mrays_per_s(self, rays_per_frame: int) -> float:
        return self.fps * rays_per_frame / 1e6

    def status_text(self, rays_per_frame: int = 0) -> str:
        txt = f"{self.frame_ms:.1f} ms ({self.fps:.1f} FPS)"
        if rays_per_frame:
            txt += f" {self.mrays_per_s(rays_per_frame):.0f} Mray/s"
        return txt
