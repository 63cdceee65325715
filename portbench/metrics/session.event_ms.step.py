"""session.event_ms.step: mean host time inside the Session event call
(key or drag), before Session.frame, from the benchmark's span around it."""


def read(ctx):
    ms = ctx.span_ms("session.event")
    return sum(ms) / len(ms) if ms else None
