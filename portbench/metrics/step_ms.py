"""step_ms: the window's wall time over the session events it completed
(host clock; each from the Session call to the return of Session.frame)."""

from harness import stats


def read(ctx):
    return stats.window_mean_ms(ctx.window_s, ctx.completed)
