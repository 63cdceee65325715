"""render.device_ms.view: device ms per view launched inside the
benchmark's span around the 32-sample render (pose program and burst,
engine/blocked.py), from the profiler's device events."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_ms("render")
    return ms / ctx.completed if ms > 0 else None
