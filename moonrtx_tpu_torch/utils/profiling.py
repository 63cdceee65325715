"""Profiling: frame-time statistics and torch.profiler traces.

Port of moonrtx_tpu/utils/profiling.py. FrameStats (a copy) feeds the
status bar / bench; trace() wraps torch.profiler for TensorBoard-
compatible traces of render bursts (the card's kernels included when one
is present), annotate() names a region in them.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque
from typing import Optional


class FrameStats:
    """Rolling frame-time statistics (for the status bar and bench)."""

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


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a trace of the enclosed block (TensorBoard format) into
    log_dir, by default moonrtx_trace under the temporary directory."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "moonrtx_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


@contextlib.contextmanager
def annotate(name: str):
    """Named region in traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield
