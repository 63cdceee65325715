"""Statistics of a run: tails, whole-window means, busy time."""

from __future__ import annotations

from typing import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_mean_ms(window_s: float, completed: int) -> float:
    """The window's wall time over the requests it completed, in ms."""
    if completed <= 0:
        raise ValueError("no request completed in the window")
    return window_s * 1e3 / completed


def union_length(intervals: Iterable[tuple[float, float]]) -> float:
    """Total length covered by the union of [start, end) intervals: time
    in which at least one operation ran (overlaps counted once)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[tuple[float, float]], start: float,
         end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end) that no interval covers, in order."""
    out = []
    t = start
    for s, e in sorted(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out


def idle_share(intervals: Sequence[tuple[float, float]], start: float,
               end: float) -> float:
    """1 - (union of busy intervals inside [start, end)) / (end - start)."""
    clipped = [(max(s, start), min(e, end)) for s, e in intervals]
    return 1.0 - union_length(clipped) / (end - start)
