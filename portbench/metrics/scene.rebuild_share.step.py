"""scene.rebuild_share.step: the share (%) of the window's session events
that rebuilt the pose windows, from the kernels' launch counters. On the
blocked path a rebuild cuts the height, albedo and shadow|bounce windows
with K5 (three launches); a time step that keeps the windows cuts only the
shadow|bounce ones, a drag that keeps them none."""

REBUILD_LAUNCHES = 3


def read(ctx):
    if not ctx.on_card or not ctx.launches:   # kernels count on the card
        return None
    n = sum(1 for c in ctx.launches
            if c.get("extract_level_windows", 0) >= REBUILD_LAUNCHES)
    return 100.0 * n / len(ctx.launches)
