"""sample.roofline.step: the blocked backend's sample kernel's share (%) of
its roofline over one event's frame (csrc/blocked_sample.cu, launched by
ops/blocked_sample.py::blocked_sample once a sample: the march, the
shadow|bounce lookup, the shading and the composite).

The event is one more request of the cell's traffic after the window,
with every launch recorded. The least time counts, from the recorded
arguments and the sample's hits (the wrapper run again on them): the two
output planes written once (rgb and the hit buffer, 28 B a pixel); of
every ray its chord flag and one direction (13 B: a ray without a chord
needs only its scene-frame direction, for the sun disk) and, of a ray
with a chord, its two chord ends (8 B); the height window and its mean
of each block with a live ray once. The albedo and shadow|bounce windows
do not count whole, since a kernel reads only where a hit's taps land,
and the per-block origins and the frame's numbers are left out. The
operations are the plain version's float32 operations
(ops/blocked_sample.py::blocked_sample_plain, one an elementwise torch
operation and element, a transcendental function one): one coarse
evaluation of the field for each ray with a chord, and for each ray that
hits the 8 bisections, the final point, the height and its five samples
for the normal, the albedo, the shadow|bounce lookup where the sample has
shadow windows, the shading and the composite. So no correct kernel can
read over 100%. The device time is the probe's events whose name holds
``blocked_sample_kernel``. A program without the kernel records no such
call, and the metric is left out."""

from harness import roofline

WRAPPER = "blocked_sample"
KERNEL = "blocked_sample_kernel"

WIN = 40 * 64          # a block's height window (engine/blocked.py)
BLOCK = 128            # rays of an 8x16-pixel block

# the plain version's float32 operations, a ray (engine/blocked.py)
LATLON = 14            # unit_to_latlon: |p| (6), the sine's argument and
#                        its clamp (3), asin, atan2, the negation, two
#                        degree scalings
HEIGHT = 44            # _sample_height: latlon_to_rowcol (12),
#                        _local_coords (11), window_bilinear (20), the mean
FIELD = 6 + LATLON + HEIGHT + 8   # the point (6); |p| (6), R * h, the sum
COARSE = 2 + FIELD + 1            # the coarse point t_k and the sign test
BISECT = 2 + FIELD + 3            # the midpoint, the sign test, two wheres
FINAL = 2 + 6 + LATLON            # t_hit, the hit point, its latitude
NORMAL = 25 + 6 + 4 * 58 + 13 + 15 + 10 + 12
#                        normal_step_texels (25), dlat, cos and dlon (6),
#                        four displaced points (a step, a height, the
#                        radius, latlon_to_unit's 9 and 3 products), the
#                        centre point (13), the differences and the cross
#                        product (15), normalising (10), the outward sign
ALBEDO = 12 + 11 + 37  # the albedo level's row and column, its window's
#                        coordinates, the bilinear of three channels
SHADOW = 39 + 15 + 20 + 2   # rowcol_of_points, the stride and the night
#                        gate, the shadow half's bilinear, the selects
BOUNCE = 21            # the bounce half's bilinear and its select
LAMBERT = 13 + 5 + 3 + 5    # the light direction, n.l, its clamp and
#                        select, the irradiance product and the albedo
SOFT = 23              # soft_ndotl, for a block with a normal-tilt sigma
LUNAR = 14             # the lunar-Lambert blend
EARTH = 111            # earth_light_terms: the Earth direction, the
#                        separation, the disk coverage (52), the tint and
#                        earthshine, the sum
COMPOSITE = 15         # the hit point in the scene frame


def count(call, out=None):
    """(bytes, float32 operations) of one sample's least time; ``out``:
    the sample's output (the wrapper is run again when None)."""
    if out is None:
        from moonrtx_tpu_torch import kernels

        out = kernels.wrappers()[WRAPPER](**call)
    height, width = call["height"], call["width"]
    live = call["geom"].hit_outer.reshape(-1, BLOCK)
    hit = out.hitbuf[..., 3] > 0
    # the hits in block layout: 8x16-pixel blocks, block-row-major
    hit_b = hit.reshape(height // 8, 8, width // 16, 16).permute(
        0, 2, 1, 3).reshape(-1, BLOCK)
    n_rays, n_live = live.numel(), int(live.sum())
    n_hit = int(hit.sum())
    n_soft = int((hit_b & (call["org"].sigma > 1e-6)[:, None]).sum())
    blocks = int(live.any(dim=1).sum())
    by = n_rays * (28 + 13) + n_live * 8 + blocks * (WIN + 1) * 4
    per_hit = 8 * BISECT + FINAL + HEIGHT + NORMAL + ALBEDO + LAMBERT \
        + COMPOSITE
    sw, fp = call["shadow_windows"], call["fp"]
    if sw is not None:
        per_hit += SHADOW + (BOUNCE if sw.swin.shape[-1] > 48 else 0)
    if fp.lunar_blend is not None:
        per_hit += LUNAR
    if fp.earth is not None:
        per_hit += EARTH
    ops = n_live * COARSE + n_hit * per_hit + n_soft * SOFT
    return by, ops


def read(ctx):
    probe = ctx.probe()
    if probe is None:
        return None
    calls = [c for name, c in probe["calls"] if name == WRAPPER]
    return roofline.share(calls, probe["trace"].kernel_ms(KERNEL), count)
