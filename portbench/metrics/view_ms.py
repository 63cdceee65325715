"""view_ms: the window's wall time over the views it completed (host clock;
each view from the date change to the uint8 frame on the host)."""

from harness import stats


def read(ctx):
    return stats.window_mean_ms(ctx.window_s, ctx.completed)
