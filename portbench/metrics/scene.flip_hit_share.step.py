"""scene.flip_hit_share.step: of the session's date changes, the share (%)
that the scene's one-deep flip cache served (a W/Q direction flip back to
the step just rendered: no device work), from the program's counters
``flip.hit`` and ``flip.miss`` (moonrtx_tpu_torch/utils/profiling.py).

The counters run from the process's start, so the share covers the run's
requests, the warm-up's four among them, not the window alone. Read on the
card's runs, as the other counters; a program without the counters reads
nothing."""


def read(ctx):
    if not ctx.on_card:
        return None
    try:
        from moonrtx_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    hit, miss = c.get("flip.hit", 0), c.get("flip.miss", 0)
    if hit + miss == 0:
        return None
    return 100.0 * hit / (hit + miss)
