"""rays.roofline.step: the ray-setup kernel's share (%) of its roofline over
one event's frame (csrc/ray_setup.cu, launched by ops/ray_setup.py::
block_rays once a sample on the blocked path: the jittered rays, their
shell chords, the chord bound from the max map and the collapse of the
rays without a chord).

The event is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts, from the recorded
arguments: the outputs written once (of every ray its body-frame
direction, chord ends and chord flag, 21 B, and its scene-frame
direction where the call asks for it, 12 B more; the bound of each block
where the call computes it, 4 B), a cached bound read once (4 B a
block), and the max map's distinct texels that the chord samples land on,
read once; the camera's numbers are left out. The operations are the
plain version's float32 operations (ops/ray_setup.py::block_rays_plain,
one an elementwise torch operation and element, a transcendental function
one). So no correct kernel can read over 100%. The device time is the
probe's events whose name holds ``ray_setup_kernel``. After a 51 s
traced window the profiler loses the probe's first kernel, and the ray
setup is the event's first; then the window's own such events count, per
launch of the wrapper, for each recorded call. A program without the kernel records no such call, and the
metric is left out."""

from harness import roofline

WRAPPER = "block_rays"
KERNEL = "ray_setup_kernel"

BLOCK = 128            # rays of an 8x16-pixel block
SAMPLES = 16 * 6       # chord samples of a block: 16 rays x 6 fractions

OUT_RAY = 12 + 4 + 4 + 1   # body-frame direction, chord ends, chord flag
OUT_DIRS = 12              # the scene-frame direction
HB = 4                     # a block's bound, float32

# the plain version's float32 operations
UV = 6                 # one image-plane coordinate, v of a row or u of a
#                        column (the offset, the half pixel, the jitter,
#                        scale, divide, shift)
DIR = 15 + 10          # the direction from u and v (15), normalising (10)
ROTATE = 15            # transpose(rotation) times it
SHELLS = 2 * 14 + 4    # two ray_sphere calls (the dot, disc, test, clamp,
#                        root, both ends), the entry's clamp, the end's
#                        test and select
POINT = 2 + 6 + 14 + 6 + 7 + 2 + 1
#                        a chord sample: t, the point, unit_to_latlon (14),
#                        the row (6), the column (7), the index, the max
BOUND = 5              # a block's margin, clamp, radius, square and term
CLIP = 21              # the dot again, disc, test, clamp, root, both ends,
#                        selects, max, min and the new chord flag
COLLAPSE = 7           # the masking, the count, the sum, two selects
COLLAPSE_BLOCK = 2     # the mean's division and its NaN replacement


def count(call):
    """(bytes, float32 operations) of one ray setup's least time."""
    height, width = call["height"], call["width"]
    nblk = (height // 8) * (width // 16)
    n_rays = nblk * BLOCK
    maxmap, h_bound = call["maxmap"], call["h_bound"]
    sampled = maxmap is not None and h_bound is None
    bounded = maxmap is not None or h_bound is not None
    by = n_rays * (OUT_RAY + (OUT_DIRS if call["image_dirs"] else 0))
    ops = n_rays * (DIR + ROTATE + SHELLS + COLLAPSE
                    + (CLIP if bounded else 0)) + nblk * COLLAPSE_BLOCK
    # the image path makes v once a row and u once a column
    ops += UV * ((height + width) if call["image_dirs"] else 2 * n_rays)
    if h_bound is not None:
        by += HB * nblk
        ops += (BOUND - 1) * nblk
    if sampled:
        by += HB * nblk + texels(call) * maxmap.element_size()
        ops += nblk * (SAMPLES * POINT + BOUND)
    return by, ops


def texels(call) -> int:
    """The max map's distinct texels that the call's chord samples read."""
    import torch

    from moonrtx_tpu_torch.ops import ray_setup

    _, db, ob, _, t_enter, t_end = ray_setup.shell_chords(
        call["basis"], call["rotation"], call["jitter"], call["height"],
        call["width"], call["h_min"], call["row_offset"],
        call["full_height"], image_dirs=False)
    idx = ray_setup.sampled_texels(ob, db, t_enter, t_end,
                                   *call["maxmap"].shape)
    return int(torch.unique(idx).numel())


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    if not calls:
        return None
    ms = probe["trace"].kernel_ms(KERNEL)
    launched = sum(c.get(WRAPPER, 0) for c in ctx.launches)
    if ms <= 0.0 and ctx.trace is not None and launched:
        ms = ctx.trace.kernel_ms(KERNEL) / launched * len(calls)
    return roofline.share(calls, ms, count)
