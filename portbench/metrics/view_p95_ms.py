"""view_p95_ms: the 95th percentile of all the window's view times (host
clock, each synchronised by the frame's copy to the host)."""

from harness import stats


def read(ctx):
    return stats.percentile(ctx.latencies_ms, 95.0)
