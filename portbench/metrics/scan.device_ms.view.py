"""scan.device_ms.view: device ms per view launched inside the benchmark's
span around scene.shadow_args() (shadow scan and bounce pyramid,
ops/shadow_scan.py), from the profiler's device events."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.device_ms("scan")
    return ms / ctx.completed if ms > 0 else None
