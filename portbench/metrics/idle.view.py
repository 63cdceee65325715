"""idle.view: 1 - (union of the device's busy intervals) / (traced window),
in %, over the traced window of the jump traffic."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * ctx.trace.idle_share()
