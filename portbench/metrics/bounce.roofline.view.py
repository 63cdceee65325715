"""bounce.roofline.view: the bounce kernels' share (%) of their roofline
over one view's bounce pyramid (csrc/bounce.cu, launched by
ops/shadow_scan.py::bounce_from_parts: ``bounce_pyramid_kernel`` once a
bounce, ``bounce_collapse_kernel`` once a level and bounce).

The view is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts, from the recorded
arguments alone: hs, factor and alb_s read once and the map written once
(float32); of each coarser level its heights and their block maxima
once, and its radiosity once a bounce; and the plain version's float32
operations (ops/shadow_scan.py::bounce_from_parts_plain) a cell of each
level, summed over the levels and the bounces. The device time is the
probe's events whose name holds ``bounce_`` (both kernels; no other
operation of the program's has it). A program without the kernels
records no such call, and the metric is left out."""

from harness import roofline

WRAPPER = "bounce_from_parts"
KERNEL = "bounce_"

# the plain version's float32 operations, a cell of a level and bounce
SECTORS = 8 * 15       # a sector: two height differences and their clamps,
#                        two tangents (divisions), two sin^2 (two products,
#                        a sum and a division each), the far-or-near compare
BLUR = 10 + 2          # the radius-2 box blur of the radiosity (8 sums, 2
#                        scalings), h_blk (a sum, a scaling)
COLLAPSE = 16 * 6 + 8  # where a coarser level exists: its 16 planes
#                        upsampled and blurred with radius 1 (4 sums, 2
#                        scalings each), the fine-or-coarse compare a sector
DECIMATE = 4 + 3 + 4   # a cell of a coarser level: the mean of heights,
#                        their maximum, the mean of radiosity
SUM = 8 + 7 + 1 + 2    # level 0: s2 x j a sector, their sum, the scale, the
#                        clamp
NDL = 20               # level 0 of the first bounce: slopes, n.l, radiosity
SECOND = 2             # level 0 of the second bounce: albedo x the first
#                        bounce's map, the two maps' sum

# ops/shadow_scan.py BOUNCE_MAX_LEVELS and BOUNCE_MIN_SIZE
MAX_LEVELS, MIN_SIZE = 7, 16


def levels(n_theta: int, n_phi: int) -> int:
    """The pyramid's level count (ops/shadow_scan.py::bounce_levels)."""
    n = 1
    while (n < MAX_LEVELS and n_theta % (2 ** n) == 0
           and n_phi % (2 ** n) == 0
           and min(n_theta, n_phi) // (2 ** n) >= MIN_SIZE):
        n += 1
    return n


def count(call):
    n_theta = call["n_coarse"] + call["n_fine"]
    n_phi = call["n_phi"]
    passes = 2 if call["n_bounces"] >= 2 else 1
    cells = [(n_theta >> k) * (n_phi >> k)
             for k in range(levels(n_theta, n_phi))]
    n0 = cells[0]
    by = roofline.nbytes(call["hs"], call["factor"], call["alb_s"]) + 4 * n0
    by += 4 * sum(cells[1:]) * (2 + passes)
    per_bounce = (sum(cells) * (SECTORS + BLUR) + sum(cells[:-1]) * COLLAPSE
                  + sum(cells[1:]) * DECIMATE + n0 * SUM)
    ops = passes * per_bounce + n0 * NDL + (passes - 1) * n0 * SECOND
    return by, ops


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    return roofline.share(calls, probe["trace"].kernel_ms(KERNEL), count)
