"""setup_s: process start to the first timed request (host clock): loading
the maps and pyramid caches, the upload, the kernels' build or load, and
the warm-up requests."""


def read(ctx):
    return ctx.setup_s
